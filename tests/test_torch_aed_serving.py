"""PyTorch port, the AED serving path: ``ASRPipeline`` (whose default
``model_type`` is now "aed", as the JAX package's is) and ``EndpointHandler``
against the JAX ``ASRPipeline(model_type="aed")`` at fp32, on one seeded tiny
DeCRED checkpoint written both ways (orbax params for the JAX package,
``config.json`` + ``pytorch_model.bin`` from ``export_joint`` for the port).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.interop.export_hf import export_joint, save_torch_checkpoint
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JEnc
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from huggingface_asr_tpu.serving.pipeline import ASRPipeline as JPipeline
from huggingface_asr_tpu.training.model_factory import save_params
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline, EndpointHandler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (0.5, 1.0)
VOCAB = 80  # at least the search's 64 candidates
ENC = dict(hidden_size=48, num_hidden_layers=1, num_attention_heads=2, intermediate_size=96, conv_dim=(8, 8),
           csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=VOCAB, hidden_dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0, csgu_conv_dropout=0.0, final_dropout=0.0)
DEC = dict(vocab_size=VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2, head_locations=(1,),
           head_weights=(0.3, 0.7), resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)


def _tokenizer_dir(path):
    """A word-level tokenizer with <s>, </s>, <unk>, <pad> at 0-3 (bos/eos/pad 0/1/3)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"<s>": 0, "</s>": 1, "<unk>": 2, "<pad>": 3, **{f"w{i}": i for i in range(4, VOCAB)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                            pad_token="<pad>").save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jcfg = JJoint(encoder=JEnc(**ENC), decoder=JDec(**DEC))
    x = jnp.zeros((1, 64, 80), jnp.float32)
    labels = jnp.zeros((1, 4), jnp.int32)
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.key(0), x, jnp.asarray([64]), labels=labels,
                                                      label_lengths=jnp.asarray([4])))["params"]
    tree = randomize(shapes, np.random.default_rng(11))
    root = tmp_path_factory.mktemp("torch_port_aed")
    model_dir = str(root / "model")
    os.makedirs(model_dir)
    save_params(tree, model_dir, jcfg)
    save_torch_checkpoint(export_joint(tree, jcfg.encoder, jcfg.decoder), os.path.join(model_dir, "pytorch_model.bin"))
    return model_dir, _tokenizer_dir(str(root / "tok"))


def _audio(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.1 for n in lengths]


def test_aed_transcripts_match_jax_pipeline(checkpoint):
    """Byte-identical transcripts, fp32, beams 5, ctc 0.3, max_length 16."""
    model_dir, tok_dir = checkpoint
    kw = dict(tokenizer_dir=tok_dir, model_type="aed", dtype="float32", length_buckets=BUCKETS, max_length=16)
    batch = _audio(1, [4000, 7500, 12000, 16000])
    ref = JPipeline(model_dir, **kw)(batch)
    got = ASRPipeline(model_dir, **kw, device="cpu")(batch)
    assert got == ref
    assert any(len(t) for t in got)


def test_default_model_type_is_aed_and_the_endpoint_takes_num_beams(checkpoint):
    """``ASRPipeline(dir)`` builds the joint model, as in the JAX package, and
    ``EndpointHandler(dir, num_beams=5)`` serves a request."""
    model_dir, tok_dir = checkpoint
    pipe = ASRPipeline(model_dir, tokenizer_dir=tok_dir, dtype="float32", length_buckets=BUCKETS, max_length=16,
                       device="cpu")
    assert pipe.model_type == "aed" and not pipe._use_fused
    wav = _audio(3, [7000])[0]
    handler = EndpointHandler(model_dir, tokenizer_dir=tok_dir, num_beams=5, dtype="float32",
                              length_buckets=BUCKETS, max_length=16, device="cpu")
    out = handler({"inputs": {"array": wav.tolist()}})
    assert isinstance(out["text"], str) and out["text"] == pipe(wav)


def test_aed_pipeline_runs_with_jax_blocked(tmp_path):
    """The AED route imports neither jax nor the JAX package: a seeded random
    joint model, written by the port, is served in a process where importing
    jax fails, in fp32 and bf16, and through the kernel route's plain versions."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np, torch
        from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
        from huggingface_asr_tpu_torch.models.ebranchformer import init_random_
        from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
        from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
            JointCTCAttentionConfig, JointCTCAttentionEncoderDecoder)
        from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
        from huggingface_asr_tpu_torch.training.model_factory import save_params

        class Table:
            bos_token_id, eos_token_id, pad_token_id, unk_token_id = 0, 1, 3, 2
            def __len__(self):
                return 80
            def decode(self, ids, skip_special_tokens=True):
                return " ".join(f"t{{i}}" for i in ids if i > 3)

        cfg = JointCTCAttentionConfig(
            encoder=EBranchformerConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                                        intermediate_size=128, csgu_kernel_size=7, merge_conv_kernel=7,
                                        vocab_size=80),
            decoder=GPT2DecoderConfig(vocab_size=80, n_embd=32, n_layer=1, n_head=2, n_positions=32))
        model = init_random_(JointCTCAttentionEncoderDecoder(cfg), torch.Generator().manual_seed(0))
        save_params(model, {str(tmp_path)!r})
        wav = [np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1 for n in (5000, 8000)]
        for dtype, fused in (("float32", False), ("bfloat16", False), ("bfloat16", True)):
            pipe = ASRPipeline({str(tmp_path)!r}, dtype=dtype, tokenizer=Table(), length_buckets=(1.0,),
                               max_length=8, fused_encoder=fused, device="cpu")
            assert pipe.model_type == "aed" and pipe._use_fused == fused
            assert len(pipe(wav)) == 2
        assert sys.modules["jax"] is None
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "huggingface_asr_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path), env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
