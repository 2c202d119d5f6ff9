"""PyTorch port, the trained-checkpoint transcript gate (level 3 of ROADMAP.md's
"held against") on the CTC command-line surface.

The gate model (``huggingface_asr_tpu_torch/assets/gate_ctc/``: ``config.json``,
``pytorch_model.bin`` in fp32, the tokenizer) was trained once through the JAX
CLIs on the easy synthetic corpus, from the repository root:

    JAX_PLATFORMS=cpu python -c "from huggingface_asr_tpu.data.synthetic_speech import build_corpus; \\
        build_corpus('gate/ds', n_train=512, n_eval=64, seed=0)"
    JAX_PLATFORMS=cpu python -m huggingface_asr_tpu.cli.train_tokenizer --dataset_name gate/ds \\
        --load_from_disk --no-do_resample --tokenizer_type unigram --vocab_size 40 \\
        --tokenizer_output_dir gate/tok
    JAX_PLATFORMS=cpu python -m huggingface_asr_tpu.cli.train_ctc --dataset_name gate/ds \\
        --load_from_disk --no-do_resample --tokenizer_name gate/tok --model_config gate/model.json \\
        --dtype float32 --output_dir gate/ctc --per_device_train_batch_size 16 \\
        --per_device_eval_batch_size 32 --max_steps 1200 --logging_steps 50 --eval_steps 400 \\
        --save_steps 1200 --warmup_steps 240 --learning_rate 2e-3 --max_duration_in_seconds 6 \\
        --pad_to_multiple 100
    JAX_PLATFORMS=cpu python export_jax_checkpoint.py gate/ctc/final huggingface_asr_tpu_torch/assets/gate_ctc
    cp gate/tok/{tokenizer.json,tokenizer_config.json,special_tokens_map.json} \\
        huggingface_asr_tpu_torch/assets/gate_ctc/
    JAX_PLATFORMS=cpu python tests/test_torch_cli_gate.py   # writes jax_reference.json

with ``gate/model.json`` = ``GATE_CONFIG`` below (hidden 64, 2 heads of 32:
the kernel route's gate takes it, so the card runs the log-mel and layer
kernels on it). ``jax_reference.json`` holds what the JAX evaluate CLI gives
for the corpus's 64 test utterances (``corpus_rows(512, 64, seed=0)["test"]``,
batches of 32): fp32 token ids and transcripts, bf16 token ids, and the bf16
model's per-frame argmax ids (which the card's kernel route is held to);
and, under ``"serving"``, the ids and per-frame argmax ids of the JAX
serving composition (``jax_serving_reference``: what ``serving/pipeline.py``
composes on a TPU, ``set_numeric_profile("serving")``, the bf16-DFT
``PallasLogMelFrontEnd`` with the fused CMVN, ``ctc_infer_fused`` and the
greedy decode, here in interpret mode) on requests of 16 utterances padded
to the pipelines' length buckets.

Held here, on the CPU:
- both packages' ``cli/evaluate.py`` at fp32 write byte-identical
  ``predictions_test.csv`` files (64/64 transcripts; at least 48 non-empty,
  and JAX's WER below 1.0), and the port's ``ASRPipeline(model_type="ctc")``
  gives the same 64;
- the port's ``ctc_infer(..., plain=True)`` in bf16 gives JAX's bf16 model's
  64 id sequences, but for ties by the triage rule: at the first frame where
  the argmax ids differ, JAX's top-two logit gap is within 2^-7 of the
  utterance's logit scale (its largest |logit|); each gap is printed;
- the committed JSON is what the JAX CLI gives now, and its ``"serving"`` ids
  what the JAX serving composition gives now on the first request;
- the port's ``ASRPipeline(model_type="ctc")`` on its serving route (the
  default ``numeric_profile``; on the CPU every kernel's plain version) gives
  the JAX serving ids, 64/64 but for ties by the triage rule (at the first
  frame where the port's argmax ids leave JAX's, the port's top-two logit
  gap within 2^-7 of its logit scale); each gap is printed.
"""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_DIR = os.path.join(REPO, "huggingface_asr_tpu_torch", "assets", "gate_ctc")
REFERENCE = os.path.join(GATE_DIR, "jax_reference.json")
GATE_CONFIG = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 256,
               "conv_dim": [32, 32], "conv_kernel": [3, 3], "conv_stride": [2, 2], "conv_padding": [1, 1]}
N_TRAIN, N_TEST, BATCH = 512, 64, 32
SERVING_BATCH = 16  # utterances a serving request
TIE = 2.0 ** -7


class Recording:
    """A tokenizer that records the ids the CLI decodes."""

    def __init__(self, tok):
        self.tok, self.ids = tok, []

    def __len__(self):
        return len(self.tok)

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def decode(self, ids, skip_special_tokens=True):
        self.ids.append([int(i) for i in ids])
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


def gate_rows():
    from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows

    return corpus_rows(N_TRAIN, N_TEST, seed=0)["test"]


def _read_predictions(path):
    with open(path, newline="") as f:
        return [row["prediction"] for row in csv.DictReader(f)]


def _collapse(frame_ids, blank):
    out, prev = [], blank
    for t in frame_ids:
        if t != blank and t != prev:
            out.append(int(t))
        prev = t
    return out


def _jax_batches(rows):
    """The JAX evaluate CLI's batches of the test split: (features, feature lengths, number of real rows)."""
    import jax.numpy as jnp

    from huggingface_asr_tpu.cli.common import eval_batches
    from huggingface_asr_tpu.data.bucketing import BucketingConfig
    from huggingface_asr_tpu.data.collator import CollatorConfig, SpeechCollator
    from huggingface_asr_tpu.ops.features import LogMelConfig, LogMelFrontEnd

    from huggingface_asr_tpu_torch.data.datasets import ColumnTable

    collator = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(batch_size=BATCH, pad_to_multiple=16000)))
    frontend = LogMelFrontEnd(LogMelConfig())
    for batch in eval_batches(ColumnTable(rows), collator, BATCH):
        feats, lens = frontend(jnp.asarray(batch["input_values"]), jnp.asarray(batch["input_values_lengths"]))
        yield np.asarray(feats), np.asarray(lens), int(batch["_num_real"])


def jax_reference(work, rows):
    """What the JAX evaluate CLI gives on the gate model, at fp32 and bf16,
    and the bf16 model's per-frame argmax ids."""
    import datasets
    import jax
    import jax.numpy as jnp

    import huggingface_asr_tpu.cli.evaluate as j_evaluate
    from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
    from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
    from huggingface_asr_tpu.training.model_factory import save_params

    from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state

    corpus = os.path.join(work, "ds")
    if not os.path.exists(corpus):
        datasets.DatasetDict({"test": datasets.Dataset.from_dict(rows)}).save_to_disk(corpus)
    with open(os.path.join(GATE_DIR, "config.json")) as f:
        jcfg = JConfig.from_dict(json.load(f))
    tree = flax_tree_from_state_dict(load_state(GATE_DIR), load_config(GATE_DIR))
    jax_dir = os.path.join(work, "jax_model")
    save_params(tree, jax_dir, jcfg)

    from transformers import AutoTokenizer

    out = {}
    for dtype in ("float32", "bfloat16"):
        rec = Recording(AutoTokenizer.from_pretrained(GATE_DIR))
        out_dir = os.path.join(work, f"jax_eval_{dtype}")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_evaluate, "load_tokenizer", lambda name: rec)
            results = j_evaluate.main(["--dataset_name", corpus, "--load_from_disk", "--no-do_resample",
                                       "--tokenizer_name", GATE_DIR, "--from_pretrained", jax_dir,
                                       "--model_type", "ctc", "--fused_encoder", "off", "--dtype", dtype,
                                       "--batch_size", str(BATCH), "--output_dir", out_dir])
        out[dtype] = {"ids": rec.ids[:N_TEST],
                      "transcripts": _read_predictions(os.path.join(out_dir, "predictions_test.csv")),
                      "wer": results["test"].metrics["wer"]}
    model = JModel(jcfg, dtype=jnp.bfloat16)
    def frame_argmax(feats, lens):
        res = model.apply({"params": tree}, feats, lens, deterministic=True)
        return res.logits.astype(jnp.float32).argmax(-1), res.logit_lengths

    apply = jax.jit(frame_argmax)
    frames = []
    for feats, lens, n in _jax_batches(rows):
        ids, olens = (np.asarray(x) for x in apply(jnp.asarray(feats), jnp.asarray(lens)))
        frames += [ids[b, :olens[b]].tolist() for b in range(n)]
    out["bfloat16"]["frame_ids"] = frames
    out["blank_id"] = jcfg.vocab_size
    return out


def serving_requests(rows):
    """The gate's test utterances as requests of ``SERVING_BATCH``, padded as
    the pipelines pad them (the JAX ``ASRPipeline._bucket_pad``, default
    length buckets): a list of (waveforms (16, S) f32, lengths (16,) int32)."""
    import types

    from huggingface_asr_tpu.serving.pipeline import ASRPipeline as JPipeline

    buckets = types.SimpleNamespace(length_buckets=[2.0, 5.0, 10.0, 20.0, 30.0], sampling_rate=16000)
    out = []
    for i in range(0, N_TEST, SERVING_BATCH):
        audios = [np.asarray(a, np.float32) for a in rows["audio"][i:i + SERVING_BATCH]]
        out.append((JPipeline._bucket_pad(buckets, audios), np.asarray([len(a) for a in audios], np.int32)))
    return out


def jax_serving_reference(rows, n_requests=None):
    """The JAX serving composition on the gate model, in interpret mode: what
    ``huggingface_asr_tpu/serving/pipeline.py:86-124`` runs on a TPU
    (``set_numeric_profile("serving")``, ``PallasLogMelFrontEnd`` with
    ``matmul_precision="bf16"`` and the fused CMVN, ``ctc_infer_fused`` at the
    pipeline's ``bb``, ``ctc_greedy_decode``), the profile restored to
    "bitexact" after. Returns {"ids": token ids, "frame_ids": per-frame argmax
    ids} of the first ``n_requests`` requests' utterances (all by default)."""
    import jax.numpy as jnp

    from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
    from huggingface_asr_tpu.models.fast_infer import ctc_infer_fused
    from huggingface_asr_tpu.ops import pallas_layer
    from huggingface_asr_tpu.ops.ctc import ctc_greedy_decode, tokens_to_lists
    from huggingface_asr_tpu.ops.features import LogMelConfig
    from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd

    from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state

    with open(os.path.join(GATE_DIR, "config.json")) as f:
        jcfg = JConfig.from_dict(json.load(f))
    tree = flax_tree_from_state_dict(load_state(GATE_DIR), load_config(GATE_DIR))
    out = {"ids": [], "frame_ids": []}
    pallas_layer.set_numeric_profile("serving")
    try:
        frontend = PallasLogMelFrontEnd(LogMelConfig(num_mel_bins=jcfg.num_fbanks, matmul_precision="bf16"),
                                        interpret=True, fused_cmvn_bf16=True)
        for wav, lens in serving_requests(rows)[:n_requests]:
            feats, feat_lens = frontend(jnp.asarray(wav), jnp.asarray(lens))
            res = ctc_infer_fused(tree, jcfg, feats, feat_lens, bb=min(8, len(lens)), interpret=True)
            toks, tlens = ctc_greedy_decode(res.logits, res.logit_lengths, blank_id=-1)
            out["ids"] += [[int(t) for t in ids] for ids in tokens_to_lists(np.asarray(toks), np.asarray(tlens))]
            frames = np.asarray(res.logits.astype(jnp.float32)).argmax(-1)
            out["frame_ids"] += [frames[b, :int(res.logit_lengths[b])].tolist() for b in range(len(lens))]
    finally:
        pallas_layer.set_numeric_profile("bitexact")
    return out


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    pytest.importorskip("datasets")
    work = str(tmp_path_factory.mktemp("cli_gate"))
    rows = gate_rows()
    ref = jax_reference(work, rows)

    from huggingface_asr_tpu_torch.cli.evaluate import main as p_evaluate

    p_out = os.path.join(work, "port_eval")
    p_evaluate(["--dataset_name", os.path.join(work, "ds"), "--load_from_disk", "--no-do_resample",
                "--tokenizer_name", GATE_DIR, "--from_pretrained", GATE_DIR, "--model_type", "ctc",
                "--dtype", "float32", "--batch_size", str(BATCH), "--output_dir", p_out, "--device", "cpu"])
    return ref, rows, work, p_out


def test_committed_reference_is_what_the_jax_cli_gives_now(gate):
    """The JAX CLI's part of the JSON (the ``"serving"`` key is held below)."""
    ref = gate[0]
    with open(REFERENCE) as f:
        committed = json.load(f)
    assert {k: v for k, v in committed.items() if k != "serving"} == json.loads(json.dumps(ref))
    for dtype in ("float32", "bfloat16"):
        assert len(ref[dtype]["ids"]) == len(ref[dtype]["transcripts"]) == N_TEST
    assert [_collapse(f, ref["blank_id"]) for f in ref["bfloat16"]["frame_ids"]] == ref["bfloat16"]["ids"]


def test_fp32_transcripts_are_byte_identical_across_the_two_clis(gate, capsys):
    ref, rows, work, p_out = gate
    j_csv = os.path.join(work, "jax_eval_float32", "predictions_test.csv")
    p_csv = os.path.join(p_out, "predictions_test.csv")
    j_texts, p_texts = _read_predictions(j_csv), _read_predictions(p_csv)
    non_empty = sum(bool(t.strip()) for t in j_texts)
    same = sum(a == b for a, b in zip(j_texts, p_texts))
    with capsys.disabled():
        print(f"\ngate, fp32: {same}/{N_TEST} transcripts equal; JAX: {non_empty}/{N_TEST} non-empty, "
              f"WER {ref['float32']['wer']:.4f}")
    assert non_empty >= 48 and ref["float32"]["wer"] < 1.0
    with open(j_csv, "rb") as a, open(p_csv, "rb") as b:
        assert a.read() == b.read()
    for name in ("predictions_test_hyp.trn", "predictions_test_ref.trn"):
        with open(os.path.join(work, "jax_eval_float32", name), "rb") as a, open(os.path.join(p_out, name), "rb") as b:
            assert a.read() == b.read()


def test_ctc_pipeline_gives_the_jax_transcripts(gate):
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline

    ref, rows = gate[0], gate[1]
    pipe = ASRPipeline(GATE_DIR, model_type="ctc", dtype="float32", device="cpu")
    texts = []
    for i in range(0, N_TEST, 16):
        texts += pipe(rows["audio"][i:i + 16])
    assert texts == ref["float32"]["transcripts"]


def test_bf16_plain_kernel_path_matches_the_jax_bf16_model(gate, capsys):
    """``ctc_infer(..., plain=True)`` in bf16 against JAX's bf16 model on the
    same features, by the triage rule."""
    import jax
    import jax.numpy as jnp

    from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
    from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel

    from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict
    from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC, ctc_infer
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_ctc_model, load_state

    ref, rows = gate[0], gate[1]
    with open(os.path.join(GATE_DIR, "config.json")) as f:
        jcfg = JConfig.from_dict(json.load(f))
    tree = flax_tree_from_state_dict(load_state(GATE_DIR), load_config(GATE_DIR))
    jmodel = JModel(jcfg, dtype=jnp.bfloat16)
    fused = FusedCTC(load_ctc_model(GATE_DIR, device="cpu"), "cpu")
    blank = jcfg.vocab_size
    equal, ties = 0, []
    k = 0
    for feats, lens, n in _jax_batches(rows):
        j_out = jmodel.apply({"params": tree}, jnp.asarray(feats), jnp.asarray(lens), deterministic=True)
        j_logits = np.asarray(j_out.logits.astype(jnp.float32))
        with torch.no_grad():
            p_out = ctc_infer(fused, torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(lens)), plain=True)
        p_logits = p_out.logits.float().numpy()
        assert np.array_equal(p_out.logit_lengths.numpy(), np.asarray(j_out.logit_lengths))
        for b in range(n):
            T = int(p_out.logit_lengths[b])
            jf, pf = j_logits[b, :T].argmax(-1), p_logits[b, :T].argmax(-1)
            assert _collapse(jf, blank) == ref["bfloat16"]["ids"][k]
            if _collapse(pf, blank) == _collapse(jf, blank):
                equal += 1
            else:
                t = int(np.flatnonzero(jf != pf)[0])
                top2 = np.sort(j_logits[b, t])[-2:]
                scale = float(np.abs(j_logits[b, :T]).max())
                ties.append((k, t, float(top2[1] - top2[0]), scale))
            k += 1
    with capsys.disabled():
        print(f"\ngate, bf16 ctc_infer(plain=True) vs JAX's bf16 model: {equal}/{N_TEST} id sequences equal"
              + "".join(f"; utterance {u} frame {t}: top-two gap {g:.5f} of scale {s:.3f} "
                        f"(bound {TIE * s:.5f})" for u, t, g, s in ties))
    assert k == N_TEST
    for u, t, gap, scale in ties:
        assert gap <= TIE * scale, f"utterance {u}: a difference at frame {t} beyond a tie"


def test_committed_serving_reference_is_what_jax_gives_now(gate):
    """The committed ``"serving"`` ids, recomputed on the first request of 16
    (the whole set takes four interpret-mode requests: ``__main__`` below)."""
    ref, rows = gate[0], gate[1]
    with open(REFERENCE) as f:
        committed = json.load(f)["serving"]
    assert len(committed["ids"]) == len(committed["frame_ids"]) == N_TEST
    assert [_collapse(f, ref["blank_id"]) for f in committed["frame_ids"]] == committed["ids"]
    now = jax_serving_reference(rows, n_requests=1)
    assert now == {k: v[:SERVING_BATCH] for k, v in committed.items()}


def test_serving_pipeline_gives_the_jax_serving_ids(gate, capsys):
    """The port's ``ASRPipeline(model_type="ctc")`` on its serving route (the
    default profile; ``fused_encoder=True`` takes the kernel route, whose
    pieces run their plain versions on the CPU) against the JAX serving ids,
    by the triage rule on the port's logits."""
    from huggingface_asr_tpu_torch.models.fast_infer import ctc_infer
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from transformers import AutoTokenizer

    rows, blank = gate[1], gate[0]["blank_id"]
    with open(REFERENCE) as f:
        want = json.load(f)["serving"]
    rec = Recording(AutoTokenizer.from_pretrained(GATE_DIR))
    pipe = ASRPipeline(GATE_DIR, model_type="ctc", fused_encoder=True, device="cpu", tokenizer=rec)
    assert pipe.numeric_profile == "serving" and pipe._frontend.mode == "bf16"
    equal, ties = 0, []
    for r, (wav, lens) in enumerate(serving_requests(rows)):
        start = r * SERVING_BATCH
        pipe([wav[b, :lens[b]] for b in range(len(lens))])
        got = rec.ids[start:start + SERVING_BATCH]
        differ = [b for b in range(len(lens)) if got[b] != want["ids"][start + b]]
        equal += len(lens) - len(differ)
        if differ:
            with torch.inference_mode():
                out = ctc_infer(pipe._fused, *pipe._frontend(torch.from_numpy(wav), torch.from_numpy(lens)))
            logits = out.logits.float().numpy()
            for b in differ:
                T = int(out.logit_lengths[b])
                pf, jf = logits[b, :T].argmax(-1), np.asarray(want["frame_ids"][start + b])
                assert _collapse(pf, blank) == got[b]
                t = int(np.flatnonzero(pf != jf)[0])
                top2 = np.sort(logits[b, t])[-2:]
                ties.append((start + b, t, float(top2[1] - top2[0]), float(np.abs(logits[b, :T]).max())))
    with capsys.disabled():
        print(f"\ngate, serving route (CPU, plain versions) vs the JAX serving composition: {equal}/{N_TEST} id "
              f"sequences equal" + "".join(f"; utterance {u} frame {t}: top-two gap {g:.5f} of scale {s:.3f} "
                                            f"(bound {TIE * s:.5f})" for u, t, g, s in ties))
    assert len(rec.ids) == N_TEST
    for u, t, gap, scale in ties:
        assert gap <= TIE * scale, f"utterance {u}: a difference at frame {t} beyond a tie"


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as work:
        ref = jax_reference(work, gate_rows())
    ref["serving"] = jax_serving_reference(gate_rows())
    with open(REFERENCE, "w") as f:
        json.dump(ref, f)
    print(f"wrote {REFERENCE}: fp32 WER {ref['float32']['wer']:.4f}, "
          f"{sum(bool(t.strip()) for t in ref['float32']['transcripts'])}/{N_TEST} non-empty")
