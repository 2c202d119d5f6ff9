"""PyTorch port, decoding: the CTC prefix scorer and the joint beam search
against the JAX package's, on the same seeded inputs.

The beam searches are driven by the same step function on both sides: a
cached "decoder" whose logits depend on the hypothesis's whole history
(a running sum of seeded rows carried in a (BW, V) cache entry, which the
beam reorder must gather), and a second one as the shallow-fusion LM.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JCfg
from huggingface_asr_tpu.decoding.beam_search import joint_beam_search as j_search
from huggingface_asr_tpu.decoding.ctc_prefix import CTCPrefixScorer as JScorer

from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig, _top_k, joint_beam_search
from huggingface_asr_tpu_torch.decoding.ctc_prefix import LOG_ZERO, CTCPrefixScorer

V = 30  # decoder vocabulary; the CTC head has V + 1 outputs, blank last


def _log_probs(rng, B, T, Vc, scale=2.0):
    x = rng.standard_normal((B, T, Vc)).astype(np.float32) * scale
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("impl", ["assoc", "scan"])
def test_prefix_scores_match_jax_over_several_steps(impl):
    """score_candidates and select_state over four steps of a fixed
    selection, including repeats of the last token, the blank and eos:
    token scores within 1e-4 absolute, forward variables too."""
    rng = np.random.default_rng(3)
    B, T, Vc, W, K = 2, 24, 12, 3, 5
    lp = _log_probs(rng, B, T, Vc)
    lens = np.array([24, 15])
    blank, eos = Vc - 1, 1
    js = JScorer(jnp.asarray(lp), jnp.asarray(lens), blank, eos, impl=impl)
    ps = CTCPrefixScorer(torch.from_numpy(lp), torch.from_numpy(lens), blank, eos, impl=impl)
    jst, pst = js.init_state(W), ps.init_state(W)
    np.testing.assert_allclose(pst.r.numpy(), np.asarray(jst.r), atol=1e-4)
    for step in range(4):
        cand = rng.integers(0, Vc, (B * W, K))
        cand[:, 0] = blank
        cand[:, 1] = eos
        if step:
            cand[:, 2] = np.asarray(jst.last)  # repeats of the last token
        j_scores, j_scored = js.score_candidates(jst, jnp.asarray(cand, jnp.int32))
        p_scores, p_scored = ps.score_candidates(pst, torch.from_numpy(cand))
        np.testing.assert_allclose(p_scores.numpy(), np.asarray(j_scores), atol=1e-4, rtol=0)
        live = np.asarray(j_scored[0]) > LOG_ZERO / 2
        np.testing.assert_allclose(p_scored[0].numpy()[live], np.asarray(j_scored[0])[live], atol=1e-4, rtol=1e-6)
        beam = rng.integers(0, W, (B, W)) + np.arange(B)[:, None] * W
        beam = beam.reshape(-1)
        pick = rng.integers(2, K, B * W)
        toks = cand[beam, pick]
        jst = js.select_state(jst, j_scored, jnp.asarray(beam), jnp.asarray(pick), jnp.asarray(toks, jnp.int32))
        pst = ps.select_state(pst, p_scored, torch.from_numpy(beam), torch.from_numpy(pick),
                              torch.from_numpy(toks))
        np.testing.assert_allclose(pst.s.numpy(), np.asarray(jst.s), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(pst.length.numpy(), np.asarray(jst.length))


def test_assoc_and_scan_agree():
    rng = np.random.default_rng(4)
    lp = torch.from_numpy(_log_probs(rng, 2, 37, 9))
    lens = torch.tensor([37, 20])
    cand = torch.from_numpy(rng.integers(0, 9, (4, 6)))
    out = {}
    for impl in ("assoc", "scan"):
        s = CTCPrefixScorer(lp, lens, 8, 1, impl=impl)
        out[impl] = s.score_candidates(s.init_state(2), cand)
    torch.testing.assert_close(out["assoc"][0], out["scan"][0], atol=1e-4, rtol=0)


def test_top_k_takes_the_lower_index_among_ties():
    """Planted ties (NEG_INF rows, repeated values): the port's selection
    equals lax.top_k's, index for index."""
    x = np.array([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9, -1e9, 0.5],
                  [-1e9] * 8,
                  [2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 2.0, 0.0]], np.float32)
    for k in (1, 3, 5, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def _tables(seed, tie=False):
    rng = np.random.default_rng(seed)
    dec = rng.standard_normal((V, V)).astype(np.float32) * 2.0
    pos = rng.standard_normal((48, V)).astype(np.float32)
    lm = rng.standard_normal((V, V)).astype(np.float32) * 1.5
    if tie:
        # whole rows of equal logits: every candidate set and every top-2W is tied
        dec[:, 10:20] = dec[:, 10:11]
        pos[:, 10:20] = 0.0
        lm[:, 10:20] = 0.0
    return dec, pos, lm


def _jax_step(table, pos):
    table, pos = jnp.asarray(table), jnp.asarray(pos)

    def step(cache, tokens, positions):
        acc = cache["acc"] + table[tokens[:, 0]]
        return acc * 0.5 + pos[positions], {"acc": acc}

    return step


def _torch_step(table, pos):
    table, pos = torch.from_numpy(table), torch.from_numpy(pos)

    def step(cache, tokens, positions):
        acc = cache["acc"] + table[tokens[:, 0]]
        return acc * 0.5 + pos[positions], {"acc": acc}

    return step


def _run_both(cfg_kw, B=2, T=20, seed=0, tie=False, space=5):
    dec, pos, lm = _tables(seed, tie)
    rng = np.random.default_rng(seed + 100)
    ctc = _log_probs(rng, B, T, V + 1)
    if tie:
        ctc[..., 10:20] = ctc[..., 10:11]
    lens = np.array([T, T - 6])[:B]
    kw = dict(num_beams=3, max_length=12, num_candidates=8, bos_token_id=0, eos_token_id=1,
              pad_token_id=3, return_components=True, space_token_id=space, **cfg_kw)
    W = kw["num_beams"]
    use_lm = kw.get("lm_weight", 0.0) != 0.0
    j_out = j_search(
        _jax_step(dec, pos), {"acc": jnp.zeros((B * W, V))}, B, JCfg(**kw),
        ctc_log_probs=jnp.asarray(ctc), ctc_lengths=jnp.asarray(lens),
        lm_step=_jax_step(lm, pos) if use_lm else None,
        init_lm_cache={"acc": jnp.zeros((B * W, V))} if use_lm else None, vocab_size=V)
    p_out = joint_beam_search(
        _torch_step(dec, pos), {"acc": torch.zeros(B * W, V)}, B, BeamSearchConfig(**kw),
        ctc_log_probs=torch.from_numpy(ctc), ctc_lengths=torch.from_numpy(lens),
        lm_step=_torch_step(lm, pos) if use_lm else None,
        init_lm_cache={"acc": torch.zeros(B * W, V)} if use_lm else None, vocab_size=V)
    return j_out, p_out


def _assert_same(j_out, p_out):
    (js, jsc, jc), (ps, psc, pc) = j_out, p_out
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-4, rtol=1e-6)
    for k in ("att", "ctc", "lm"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("lm_weight", [0.0, 0.3])
@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_beam_search_matches_jax(ctc_weight, lm_weight, early_exit):
    """n-best sequences equal, scores and components within 1e-4."""
    _assert_same(*_run_both(dict(ctc_weight=ctc_weight, lm_weight=lm_weight, early_exit=early_exit)))


@pytest.mark.parametrize("weight", [0.5, 2.0])
def test_beam_search_with_the_eos_space_trick_matches_jax(weight):
    _assert_same(*_run_both(dict(ctc_weight=0.3, apply_eos_space_trick=True, eos_space_trick_weight=weight),
                            seed=2))


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_beam_search_with_planted_ties_matches_jax(ctc_weight):
    """Ten tokens with equal logits (and equal CTC columns): every top-k of
    the search breaks ties, and must break them as lax.top_k does."""
    _assert_same(*_run_both(dict(ctc_weight=ctc_weight), seed=1, tie=True))


def test_early_exit_is_result_identical_and_stops_early():
    """With early exit the search stops once every batch element is done,
    and its result is the full run's."""
    steps = {}
    outs = {}
    dec, pos, lm = _tables(5)
    dec[:, 1] += 3.0  # eos likely after a few tokens
    ctc = _log_probs(np.random.default_rng(5), 2, 20, V + 1)
    for early in (True, False):
        taken = []
        outs[early] = joint_beam_search(
            _torch_step(dec, pos), {"acc": torch.zeros(6, V)}, 2,
            BeamSearchConfig(num_beams=3, max_length=40, num_candidates=8, ctc_weight=0.3, early_exit=early),
            ctc_log_probs=torch.from_numpy(ctc), ctc_lengths=torch.tensor([20, 14]), vocab_size=V,
            hook=lambda name, alive=None: taken.append(name) if name == "decoder" else None)
        steps[early] = len(taken)
    assert steps[False] == 39 and steps[True] < steps[False]
    for a, b in zip(outs[True], outs[False]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
