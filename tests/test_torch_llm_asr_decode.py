"""PyTorch port, LLM-ASR's greedy decode against the JAX package on the
CPU: ``llm_asr_greedy_decode`` gives the JAX tokens and lengths in both
prompting variants, on the parameter trees of ``tests/test_torch_llm_asr.py``
(split from it, whose helpers these tests share, so that the two files run on
two workers).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.llm_asr import llm_asr_greedy_decode as j_greedy
from test_torch_llm_asr import LENS, VARIANTS, _pair

from huggingface_asr_tpu_torch.models.llm_asr import llm_asr_greedy_decode


@VARIANTS
def test_greedy_decode_gives_the_jax_tokens_and_lengths(tokens):
    jm, pm, tree, x, _ = _pair(tokens)
    j_toks, j_lens = j_greedy(jm, jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(LENS), max_len=6)
    p_toks, p_lens = llm_asr_greedy_decode(pm, torch.from_numpy(x), torch.from_numpy(LENS), max_len=6)
    np.testing.assert_array_equal(p_toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(p_lens.numpy(), np.asarray(j_lens))
