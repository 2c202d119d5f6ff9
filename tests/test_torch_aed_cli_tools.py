"""PyTorch port, the joint model's command-line tools that need no JAX run:
the Whisper family's refusals in ``cli/train_aed.py``, ``cli/train_clm.py``'s
packed batches against JAX's and its ``--from_hf_gpt2`` start.

Split from ``tests/test_torch_aed_cli.py`` (whose corpus, tokenizer and text
files these tests share) so that the two files run on two workers.
"""

import json
import os

import numpy as np
import pytest
import torch

from huggingface_asr_tpu.cli import train_clm as j_train_clm
from test_torch_aed_cli import CLM, clm_texts, corpus  # noqa: F401  (fixtures)

from huggingface_asr_tpu_torch.cli import train_aed, train_clm

transformers = pytest.importorskip("transformers")


def test_train_aed_whisper_family_raises(corpus):
    """The Whisper family (``tests/test_torch_recipe_cli.py`` trains it)
    refuses an HF directory that holds safetensors weights only, naming the
    file it reads, and a run given no model at all."""
    root, path, tok, _ = corpus
    hf_dir = root / "hf_whisper"
    hf_dir.mkdir()
    (hf_dir / "config.json").write_text(json.dumps({"d_model": 32, "vocab_size": 40}))
    (hf_dir / "model.safetensors").write_bytes(b"")
    common = ["--dataset_name", path, "--load_from_disk", "--no-do_resample", "--tokenizer_name", tok,
              "--model_family", "whisper", "--output_dir", str(root / "whisper"), "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        train_aed.main([*common, "--from_hf_checkpoint", str(hf_dir)])
    with pytest.raises(ValueError, match="--model_config"):
        train_aed.main(common)


def test_packed_batches_equal_jax(corpus):
    tok = transformers.AutoTokenizer.from_pretrained(corpus[2])
    texts = corpus[3]
    j_it = j_train_clm.packed_text_batches(texts, tok, 8, 3, 0, seed=5)
    p_it = train_clm.packed_text_batches(texts, tok, 8, 3, 0, seed=5)
    for _ in range(12):  # past one epoch of the 16 texts
        j, p = next(j_it), next(p_it)
        assert set(j) == set(p)
        for k in j:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    j_ev = j_train_clm.packed_eval_batches(texts, tok, 8, 3, 0)
    p_ev = train_clm.packed_eval_batches(texts, tok, 8, 3, 0)
    assert len(p_ev) == len(j_ev) and not p_ev[-1]["label_mask"].all()
    for j, p in zip(j_ev, p_ev):
        for k in j:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_train_clm_from_hf_gpt2(corpus, clm_texts, tmp_path):
    """An HF GPT-2 checkpoint: the decoder's logits equal GPT2LMHeadModel's
    before training, the CLI trains from it, and a tokenizer larger than its
    vocabulary raises as in the JAX CLI."""
    hf_cfg = transformers.GPT2Config(vocab_size=48, n_positions=32, n_embd=32, n_layer=2, n_head=2,
                                     resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    hf.save_pretrained(str(tmp_path / "gpt2"))
    ids = {"bos": 0, "eos": 1, "pad": 3, "vocab_size": 40}
    cfg, sd = train_clm.load_hf_gpt2(str(tmp_path / "gpt2"), ids)
    from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2MultiHeadDecoder

    dec = GPT2MultiHeadDecoder(cfg)
    dec.load_state_dict(sd, strict=True)
    tokens = torch.randint(0, 40, (2, 9), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(dec(tokens).logits, hf(tokens).logits, atol=1e-5, rtol=1e-5)
    out = str(tmp_path / "from_hf")
    train_clm.main([*clm_texts, *CLM, "--max_steps", "1", "--from_hf_gpt2", str(tmp_path / "gpt2"),
                    "--output_dir", out, "--device", "cpu"])
    with open(os.path.join(out, "final", "config.json")) as f:
        assert json.load(f)["vocab_size"] == 48
    small = transformers.GPT2Config(vocab_size=30, n_positions=32, n_embd=32, n_layer=1, n_head=2)
    transformers.GPT2LMHeadModel(small).save_pretrained(str(tmp_path / "small"))
    with pytest.raises(ValueError, match="exceeds"):
        train_clm.load_hf_gpt2(str(tmp_path / "small"), ids)
