"""PyTorch port, serving pipeline vs the JAX package, and the port's guards.

One random tiny checkpoint is written both ways: orbax params for the JAX
``ASRPipeline``, and ``config.json`` + ``pytorch_model.bin`` (the file
``export_hf.save_torch_checkpoint`` writes) for the port's.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from huggingface_asr_tpu.interop.export_hf import export_ebranchformer_ctc, save_torch_checkpoint
from huggingface_asr_tpu.serving.pipeline import ASRPipeline as JPipeline
from huggingface_asr_tpu.training.model_factory import save_params
from torch_port_helpers import make_models

from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_random_
from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer, fused_encoder_refusal
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig, JointCTCAttentionEncoderDecoder
from huggingface_asr_tpu_torch.ops.features import LogMelConfig
from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline, EndpointHandler
from huggingface_asr_tpu_torch.training.model_factory import load_ctc_model
from huggingface_asr_tpu_torch.training.model_factory import save_params as save_torch_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (0.5, 1.0)


def _tokenizer_dir(path, vocab_size):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[PAD]": 0, "[UNK]": 1, **{f"w{i}": i for i in range(2, vocab_size)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]").save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    jcfg, pcfg, tree, _, _ = make_models(seed=7, hidden_size=64, num_attention_heads=2,
                                         intermediate_size=128)
    root = tmp_path_factory.mktemp("torch_port_ckpt")
    model_dir = str(root / "model")
    os.makedirs(model_dir)
    save_params(tree, model_dir, jcfg)
    save_torch_checkpoint(export_ebranchformer_ctc(tree, jcfg), os.path.join(model_dir, "pytorch_model.bin"))
    return model_dir, _tokenizer_dir(str(root / "tok"), jcfg.vocab_size)


def _audio(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) * 0.1 for n in lengths]


def test_transcripts_match_jax_pipeline(checkpoint):
    model_dir, tok_dir = checkpoint
    jp = JPipeline(model_dir, tokenizer_dir=tok_dir, model_type="ctc", dtype="float32",
                   length_buckets=BUCKETS)
    pp = ASRPipeline(model_dir, tokenizer_dir=tok_dir, model_type="ctc", dtype="float32", length_buckets=BUCKETS,
                     device="cpu")
    single = _audio(0, [6000])[0]
    batch = _audio(1, [4000, 7500, 12000, 16000])
    assert isinstance(pp(single), str)
    assert pp(single) == jp(single)
    got, ref = pp(batch), jp(batch)
    assert got == ref
    assert any(len(t) for t in got)


def test_fused_path_on_cpu_launches_nothing(checkpoint):
    """A CPU pipeline takes the plain model. The kernel path itself, on CPU
    tensors, runs every kernel's plain version: the launch counters stay at 0."""
    model_dir, tok_dir = checkpoint
    pp = ASRPipeline(model_dir, tokenizer_dir=tok_dir, model_type="ctc", dtype="bfloat16", length_buckets=BUCKETS,
                     device="cpu")
    assert not pp._use_fused
    model = load_ctc_model(model_dir, device="cpu")
    fe = MelFrontEnd(LogMelConfig(num_mel_bins=model.config.num_fbanks))
    wav = torch.from_numpy(pp._bucket_pad(_audio(2, [5000, 9000])))
    _build.reset_launch_counts()
    feats, feat_lens = fe(wav, torch.tensor([5000, 9000], dtype=torch.int32))
    out = ctc_infer(FusedCTC(model, "cpu"), feats, feat_lens)
    assert out.logits.shape[0] == 2 and bool(torch.isfinite(out.logits.float()).all())
    assert sum(_build.LAUNCHES.values()) == 0


def test_endpoint_handler(checkpoint):
    model_dir, tok_dir = checkpoint
    handler = EndpointHandler(model_dir, tokenizer_dir=tok_dir, model_type="ctc", dtype="float32",
                              length_buckets=BUCKETS, device="cpu")
    out = handler({"inputs": {"array": _audio(3, [7000])[0].tolist()}})
    assert isinstance(out["text"], str)


def test_cuda_device_without_cuda_raises(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_dir, tok_dir = checkpoint
    with pytest.raises(RuntimeError):
        ASRPipeline(model_dir, tokenizer_dir=tok_dir, model_type="ctc", device="cuda")


def test_default_device_is_the_card_and_raises_without_one(checkpoint):
    """No ``device`` argument means the card: where there is none, every
    entry point raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_dir, tok_dir = checkpoint
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ASRPipeline(model_dir, tokenizer_dir=tok_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EndpointHandler(model_dir, tokenizer_dir=tok_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_ctc_model(model_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedCTC(load_ctc_model(model_dir, device="cpu"))


def test_aed_pipeline_builds_and_decodes_on_cpu(tmp_path):
    """The joint CTC/attention route (the default ``model_type``) on a seeded
    random model written by the port: a batch decodes to one string each."""
    cfg = JointCTCAttentionConfig(
        encoder=EBranchformerConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                                    intermediate_size=128, csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=70),
        decoder=GPT2DecoderConfig(vocab_size=70, n_embd=32, n_layer=1, n_head=2, n_positions=32))
    save_torch_params(init_random_(JointCTCAttentionEncoderDecoder(cfg), torch.Generator().manual_seed(1)),
                      str(tmp_path))

    class Table:
        bos_token_id, eos_token_id, pad_token_id, unk_token_id = 0, 1, 3, None

        def __len__(self):
            return 70

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(f"t{i}" for i in ids if i not in (0, 1, 3))

    pipe = ASRPipeline(str(tmp_path), tokenizer=Table(), length_buckets=BUCKETS, max_length=10, device="cpu")
    assert pipe.model_type == "aed" and pipe._gen_cfg.num_beams == 5 and pipe._gen_cfg.ctc_weight == 0.3
    texts = pipe(_audio(4, [6000, 9000, 15000]))
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)


@pytest.mark.parametrize("num_fbanks", [129, 256])
def test_fused_gate_refuses_mel_bins_the_front_end_kernels_refuse(num_fbanks):
    """The log-mel and CMVN kernels take at most ``MEL_MAX_BINS`` (128) bins:
    a CTC model with 129 or 256 is served through the plain model, with that
    reason. The encoder's kernels do not need that limit (the subsampler
    falls back to the model's own front end), so the AED route, which keeps
    the plain log-mel, still takes the encoder kernels there."""
    cfg = EBranchformerConfig(num_fbanks=num_fbanks, hidden_size=64, num_attention_heads=2,
                              intermediate_size=128, num_hidden_layers=1, vocab_size=12)
    reason = fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True)
    assert reason is not None and f"num_fbanks {num_fbanks}" in reason and "MEL_MAX_BINS = 128" in reason
    assert fused_encoder_refusal(EBranchformerConfig(num_fbanks=80), torch.bfloat16, log_mel=True) is None
    assert fused_encoder_refusal(cfg, torch.bfloat16) is None

    model = init_random_(EBranchformerForCTC(cfg).eval(), torch.Generator().manual_seed(0))
    fused = FusedCTC(model, "cpu")
    assert fused.subsample is None
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, num_fbanks)).astype(np.float32))
    lens = torch.tensor([40, 29])
    out, hidden = ctc_infer(fused, feats, lens, return_hidden=True)
    with torch.no_grad():
        ref = model.to(torch.bfloat16)(feats.to(torch.bfloat16), lens)
    assert torch.equal(out.logit_lengths, ref.logit_lengths) and hidden.shape[-1] == 64
    T = int(ref.logits.shape[1])
    g, r = out.logits[:, :T].float(), ref.logits.float()
    valid = torch.arange(T)[None, :] < ref.logit_lengths[:, None]
    assert float((g - r).abs()[valid].max()) <= 0.05 * max(1.0, float(r.abs()[valid].max()))


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax nor the JAX package: its pipeline runs
    in a process where importing jax fails."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np, torch
        from huggingface_asr_tpu_torch.kernels.mel import MelFrontEnd
        from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
        from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_random_
        from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
        from huggingface_asr_tpu_torch.ops.features import LogMelConfig
        from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
        from huggingface_asr_tpu_torch.training.model_factory import save_params

        class Table:
            def decode(self, ids, skip_special_tokens=True):
                return " ".join(f"t{{i}}" for i in ids)

        cfg = EBranchformerConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=128, csgu_kernel_size=7, merge_conv_kernel=7,
                                  vocab_size=20)
        model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0))
        save_params(model, {str(tmp_path)!r})
        wav = [np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
               for n in (5000, 8000)]
        for dtype in ("float32", "bfloat16"):
            pipe = ASRPipeline({str(tmp_path)!r}, model_type="ctc", dtype=dtype, tokenizer=Table(),
                               length_buckets=(1.0,), device="cpu")
            assert len(pipe(wav)) == 2
        feats, lens = MelFrontEnd(LogMelConfig())(torch.from_numpy(pipe._bucket_pad(wav)),
                                                  torch.tensor([5000, 8000], dtype=torch.int32))
        assert ctc_infer(FusedCTC(model, "cpu"), feats, lens).logits.shape[0] == 2
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
