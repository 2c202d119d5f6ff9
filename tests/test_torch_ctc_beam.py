"""PyTorch port, the CTC prefix beam search vs the JAX package on the CPU:
the rolling hashes against numpy's uint32 arithmetic, the n-best lists and
scores against ``huggingface_asr_tpu.decoding.ctc_beam.ctc_beam_search`` on
the same seeded posteriors (unequal lengths, merging prefixes, ties), and a
wide beam against the exact prefix posteriors by enumeration."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from huggingface_asr_tpu.decoding.ctc_beam import CTCBeamConfig as JConfig
from huggingface_asr_tpu.decoding.ctc_beam import ctc_beam_search as j_search

from huggingface_asr_tpu_torch.decoding import ctc_beam
from huggingface_asr_tpu_torch.decoding.ctc_beam import CTCBeamConfig, ctc_beam_search


def _log_softmax(x):
    return x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)) - x.max(-1, keepdims=True)


def _both(lp, lens, **cfg):
    jt, jl, js = j_search(jnp.asarray(lp), jnp.asarray(lens), JConfig(**cfg))
    pt, pl, ps = ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(lens), CTCBeamConfig(**cfg))
    return (np.asarray(jt), np.asarray(jl), np.asarray(js)), (pt.numpy(), pl.numpy(), ps.numpy())


def _assert_same(j, p):
    (jt, jl, js), (pt, pl, ps) = j, p
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mult", [ctc_beam._H1_MULT, ctc_beam._H2_MULT])
def test_hash_step_is_uint32_arithmetic(mult):
    rng = np.random.default_rng(0)
    h = np.concatenate([rng.integers(0, 2 ** 32, 4000, dtype=np.uint64),
                        np.asarray([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31, 2 ** 32 - 1], np.uint64)]).astype(np.uint32)
    c = rng.integers(0, 5000, h.shape).astype(np.uint32)
    want = h * np.uint32(mult) + c + np.uint32(1)  # wraps mod 2^32
    got = ctc_beam._hash_step(torch.from_numpy(h.astype(np.int64)), mult, torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nbest_matches_jax_with_unequal_lengths(seed):
    rng = np.random.default_rng(seed)
    B, T, V = 3, 24, 12
    lp = _log_softmax(rng.standard_normal((B, T, V)).astype(np.float32) * 2.0).astype(np.float32)
    lens = np.asarray([T, 17, 5], np.int32)
    _assert_same(*_both(lp, lens, beam_size=6, beam_size_token=5, blank_id=-1, max_tokens=16))


def test_nbest_matches_jax_on_peaked_posteriors():
    """Peaked frames, as a trained model gives them: long runs of one token
    and of blank, so that the repeat and the extension of many prefixes
    merge; a length of 0; the output cap below the prefix lengths."""
    rng = np.random.default_rng(7)
    B, T, V = 2, 40, 8
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    ids = rng.integers(0, V, (B, T // 4)).repeat(4, axis=1)
    logits[np.arange(B)[:, None], np.arange(T)[None], ids] += 6.0
    lp = _log_softmax(logits).astype(np.float32)
    _assert_same(*_both(lp, np.asarray([T, 0], np.int32), beam_size=10, beam_size_token=4, blank_id=0,
                        max_tokens=6))


def test_two_paths_merge_into_one_prefix():
    """Frames peaked on token 1, blank, token 1: the prefix [1] is reached by
    the repeat of [1] and by extending the empty prefix, [1, 1] only through
    the blank. Merged, the n-best holds each prefix once, as JAX's does."""
    p = np.full((4, 3), 0.05, np.float32)
    p[0, 1] = p[1, 1] = p[3, 1] = 0.9
    p[2, 2] = 0.9
    lp = np.log(p / p.sum(-1, keepdims=True))[None].astype(np.float32)
    j, got = _both(lp, np.asarray([4], np.int32), beam_size=8, beam_size_token=3, blank_id=-1, max_tokens=4)
    _assert_same(j, got)
    pt, pl, ps = got
    live = ps[0] > -1e8
    seqs = [tuple(pt[0, w, : pl[0, w]]) for w in range(8) if live[w]]
    assert len(seqs) == len(set(seqs)) and seqs[0] == (1, 1)


def _exact_prefix_scores(lp, blank):
    """log P(prefix) of every label sequence, by enumerating alignments."""
    T, V = lp.shape
    out = {}
    for path in itertools.product(range(V), repeat=T):
        seq, prev = [], None
        for v in path:
            if v != blank and v != prev:
                seq.append(v)
            prev = v
        s = float(sum(lp[t, v] for t, v in enumerate(path)))
        k = tuple(seq)
        out[k] = np.logaddexp(out[k], s) if k in out else s
    return sorted(out.items(), key=lambda kv: -kv[1])


def test_wide_beam_is_exact():
    """With every prefix kept (W past their count, K = V) the scores are the
    exact sums over alignments: the recursion and the merging are right."""
    rng = np.random.default_rng(3)
    T, V = 5, 4
    lp = _log_softmax(rng.standard_normal((T, V)).astype(np.float32) * 1.5).astype(np.float32)
    exact = _exact_prefix_scores(lp, blank=3)
    pt, pl, ps = ctc_beam_search(torch.from_numpy(lp[None]), torch.tensor([T]),
                                 CTCBeamConfig(beam_size=128, beam_size_token=V, blank_id=3, max_tokens=8))
    for w, (seq, score) in enumerate(exact[:10]):
        assert tuple(pt[0, w, : pl[0, w]].tolist()) == seq
        assert abs(float(ps[0, w]) - score) < 1e-4
