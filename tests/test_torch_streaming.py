"""PyTorch port, streaming vs the JAX package on the CPU: the CTC prefix
scorer's streaming extensions (``extended``, ``extend_state``,
``replay_state``) and the two streaming sessions of ``serving/streaming.py``
on the same weights, feed by feed, behind a global-CMVN front end. The
joint session and ``generate_joint`` over the encoder variants are in
``tests/test_torch_streaming_joint.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.decoding.ctc_prefix import CTCPrefixScorer as JScorer
from huggingface_asr_tpu.ops.features import LogMelConfig as JMelCfg
from huggingface_asr_tpu.ops.features import LogMelFrontEnd as JFrontEnd
from huggingface_asr_tpu.serving.streaming import StreamingCTCSession as JCTCSession
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.decoding.ctc_prefix import CTCPrefixScorer
from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode
from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
from huggingface_asr_tpu_torch.serving.streaming import StreamingCTCSession

BUCKETS = (0.5, 1.0, 2.0)
SR = 16000


def _close(p, j, tol=1e-5):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=tol, atol=tol)


# ------------------------------------------------------------ the prefix scorer

def test_prefix_scorer_extensions_match_jax():
    """JAX ``tests/test_ctc_prefix.py::test_streaming_extension_matches_full``
    run through both packages: every state and score within 1e-5 of JAX's,
    and the replayed state equal to scoring the whole posteriors from scratch."""
    rng = np.random.default_rng(5)
    B, W, V, T1, T2 = 2, 3, 8, 12, 8
    blank, eos = 0, 1
    full = np.array(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((B, T1 + T2, V)), jnp.float32), axis=-1))
    lens1, lens2 = np.asarray([T1, T1]), np.asarray([T2, T2 - 3])
    chunk1, chunk2 = full[:, :T1], full[:, T1:]
    j_stream = JScorer(jnp.asarray(chunk1), jnp.asarray(lens1), blank, eos, impl="scan")
    p_stream = CTCPrefixScorer(torch.from_numpy(chunk1), torch.from_numpy(lens1), blank, eos, impl="scan")
    p_full = CTCPrefixScorer(torch.from_numpy(full), torch.tensor([T1 + T2, T1 + T2 - 3]), blank, eos, impl="scan")

    BW = B * W
    j_state, p_state, p_state_f = j_stream.init_state(W), p_stream.init_state(W), p_full.init_state(W)
    rng2 = np.random.default_rng(7)
    selected = []
    for _ in range(3):
        cands = rng2.integers(2, V, (BW, 4))
        cand_idx = rng2.integers(0, 4, (BW,))
        toks = cands[np.arange(BW), cand_idx]
        beams = np.arange(BW)
        _, j_sc = j_stream.score_candidates(j_state, jnp.asarray(cands, jnp.int32))
        j_state = j_stream.select_state(j_state, j_sc, jnp.asarray(beams), jnp.asarray(cand_idx), jnp.asarray(toks))
        c, ci, tk, bi = (torch.from_numpy(a) for a in (cands, cand_idx, toks, beams))
        _, p_sc = p_stream.score_candidates(p_state, c)
        p_state = p_stream.select_state(p_state, p_sc, bi, ci, tk)
        _, p_sc_f = p_full.score_candidates(p_state_f, c)
        p_state_f = p_full.select_state(p_state_f, p_sc_f, bi, ci, tk)
        selected.append(toks)
    _close(p_state.r, j_state.r)
    _close(p_state.s, j_state.s)

    j_ext = j_stream.extended(jnp.asarray(chunk2), jnp.asarray(lens2))
    p_ext = p_stream.extended(torch.from_numpy(chunk2), torch.from_numpy(lens2))
    assert p_ext.input_length == j_ext.input_length == T1 + T2
    _close(p_ext.xn, j_ext.xn, 0)
    _close(p_ext.xb, j_ext.xb, 0)

    # the cheap approximation, kept as JAX has it
    j_cont = j_ext.extend_state(j_state, T1)
    p_cont = p_ext.extend_state(p_state, T1)
    _close(p_cont.r, j_cont.r)
    assert torch.equal(p_cont.s, p_state.s) and torch.equal(p_cont.last, p_state.last)

    # the exact continuation
    prefix = np.stack(selected, axis=1)
    j_rep = j_ext.replay_state(jnp.asarray(prefix, jnp.int32), j_state.length, W)
    p_rep = p_ext.replay_state(torch.from_numpy(prefix), p_state.length, W)
    for name in ("r", "s", "last", "length"):
        _close(getattr(p_rep, name), getattr(j_rep, name))
    _close(p_rep.r, p_state_f.r.numpy(), 1e-4)
    _close(p_rep.s, p_state_f.s.numpy(), 1e-4)

    cands = torch.from_numpy(rng2.integers(2, V, (BW, 4)))
    ts_rep, _ = p_ext.score_candidates(p_rep, cands)
    j_ts, _ = j_ext.score_candidates(j_rep, jnp.asarray(cands.numpy(), jnp.int32))
    _close(ts_rep, j_ts)
    ts_full, _ = p_full.score_candidates(p_state_f, cands)
    _close(ts_rep, ts_full.numpy(), 1e-4)


# ------------------------------------------------------------ the sessions

def _frontends(seed):
    """The same global-CMVN front end in both packages (seeded statistics)."""
    rng = np.random.default_rng(seed)
    means, stds = rng.standard_normal(80) * 0.5 - 4.0, rng.uniform(1.0, 3.0, 80)
    return (JFrontEnd(JMelCfg(norm_type="global"), global_means=means, global_stds=stds),
            LogMelFrontEnd(LogMelConfig(norm_type="global"), global_means=means, global_stds=stds))


def _audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def ctc_sessions():
    """A causal rotary CTC model, 1 layer of 32, through both packages' sessions."""
    jcfg, pcfg, tree, jmodel, pmodel = make_models(
        seed=8, hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
        csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=20, is_causal=True, position_embeddings_type="rotary")
    jfe, pfe = _frontends(9)
    make_j = lambda: JCTCSession(jmodel, tree, jfe, sampling_rate=SR, bucket_seconds=BUCKETS)  # noqa: E731
    make_p = lambda: StreamingCTCSession(pmodel, pfe, sampling_rate=SR, bucket_seconds=BUCKETS,  # noqa: E731
                                         device="cpu")
    return make_j, make_p, pmodel, pfe


def test_ctc_session_matches_jax_feed_by_feed(ctc_sessions):
    make_j, make_p, pmodel, pfe = ctc_sessions
    j, p = make_j(), make_p()
    audio = _audio(2.0, 1)
    got = []
    for start in range(0, len(audio), 4000):  # 0.25 s feeds across the three buckets
        want = j.feed(audio[start:start + 4000])
        got.append(p.feed(audio[start:start + 4000]))
        assert got[-1] == want, start
    assert any(got)
    # a causal model: each feed extends the last
    assert all(b[: len(a)] == a for a, b in zip(got, got[1:]))
    # the last feed is the one-shot decode of the whole audio
    with torch.no_grad():
        feats, flens = pfe(torch.from_numpy(audio)[None], torch.tensor([len(audio)]))
        out = pmodel(feats, flens)
    toks, n = ctc_greedy_decode(out.logits, out.logit_lengths)
    assert got[-1] == toks[0, : int(n[0])].tolist() == make_p().feed(audio)
    assert p.transcript(got[-1]) == j.transcript(got[-1]) == " ".join(map(str, got[-1]))


def test_ctc_session_clamps_and_resets(ctc_sessions):
    """Audio past the last bucket is left out, as in JAX; ``reset`` starts
    over; ``transcript()`` feeds nothing and returns the current text."""
    make_j, make_p, _, _ = ctc_sessions
    audio = _audio(2.5, 2)
    j, p = make_j(), make_p()
    got = p.feed(audio)
    assert got == j.feed(audio) == make_p().feed(audio[: int(2.0 * SR)])
    assert p.transcript() == " ".join(map(str, got))
    p.reset()
    assert p.feed(audio[:8000]) == make_p().feed(audio[:8000])


def test_sessions_refuse_a_model_that_is_not_causal():
    _, _, _, _, pmodel = make_models(seed=8, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                                     intermediate_size=64, conv_dim=(8, 8), vocab_size=20)
    with pytest.raises(ValueError, match="is_causal"):
        StreamingCTCSession(pmodel, _frontends(9)[1], device="cpu")
