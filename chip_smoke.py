"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels of huggingface_asr_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   flagship shapes (B=8, 10 s -> T_in=998 mel frames, T_pad=256 encoder
   frames; and 20 s, T_pad=504; conv2 also at a frame count that is no
   multiple of its tile), with TF32 off for the plain reference, and
   times both with CUDA events (median of 5 windows of 20 kernel calls);
   the fused layer's attention kernel once more on seeded strided views at
   the 2 s, 20 s and 30 s buckets (T_pad = 56, 512, 752: fewer rows than one
   block, key loops past one tile, a ragged last tile) with lengths that
   include 0 and 1, and timed at B=128, T_pad=256; the host's time per launch
   of the two inference attention kernels; the GEMM once more at M = 32,768
   rows (B=128, T_pad=256: FF1-in, FF1-out with its residual, QKV with its
   second output, cg_w2 into a column slice of a wider buffer, and the
   subsampler's out-dense at K=5120), each beside its bound and ``F.linear``,
   at a ragged M (B=1, T_pad=56) and into each half of ``merged``, where the
   other half and the rows past M must stay untouched; the GEMM with the
   LayerNorm in its operand prologue (``csrc/gemm_ln.cu``) at each of its
   five call sites (FF1's, FF2's and cgMLP's intermediate dense with the
   GELU, the QKV with its second output, the subsampler's projection) at
   B=8 (10 s and 20 s), at M = 32,768 and 56, each against its plain
   version, beside its bound and F.layer_norm + F.linear (two calls), with
   the share of its outputs bit-equal to layer_norm then gemm (every one,
   or the run fails) and the device times of the kernel and of that chain;
   both depthwise convs
   (CSGU and merge) once more at B=128, T_pad=256, each beside its bound and
   ``F.conv1d(groups=C)``, then at B=8, 128 and 3 (T_pad 256, 256, 70) with
   K = 3, 31, 33 and t_valid = T - 5, 1, T, on an input that is a row view of
   a wider buffer, and into the first rows of a larger buffer whose other
   rows must stay untouched; the device time under the profiler of
   layernorm, pos_query, mel, cmvn, conv1 and the two depthwise convs at B=8,
   beside the library calls';
   the mel kernel, cmvn, conv1 (also the share of its outputs equal to the
   plain version's bit for bit, here and at B=8) and pos_query (flagship and
   dh 44) once more at the rows of a B=128 x 10 s request, beside their
   bounds and library calls, with device times (cmvn and conv1 also at B=8);
   and the mel kernel's accuracy gate: against the folded product in
   fp64, its largest log-mel error at most twice the fp32 plain version's,
   on speech-like input and on the same input x 1e-4, at B=8 and B=128;
4. writes a flagship E-Branchformer CTC model with seeded random weights
   (12 layers, D=256, 8 heads, I=1024, 256x256 subsampler, 500+1 outputs),
   loads it through ASRPipeline(device="cuda") and answers requests of 1, 4
   and 8 seeded synthetic utterances in the 5 s, 10 s and 20 s buckets, each
   timed once on the host clock;
5. checks that every kernel of the path launched during those requests, that
   one request of 8 utterances launches 12 standalone LayerNorms (each
   layer's final one; 61 with the LayerNorm apart from its GEMM) and 49
   GEMMs with the LayerNorm prologue, and that for every request the kernel
   path's logits and greedy ids match the plain path's on the card;
6. holds the training attention kernel (forward, and all four gradients for a
   seeded dO) and the shift-form inference attention kernel against their
   plain versions at B=8, T=250 and T=500, ragged lengths with one
   zero-length row, bf16 and fp32, dropout rate 0 and 0.1, once more at
   T=333 with rows of length 1 and 0 (the shift form also at T=70, one ragged
   tile), the training kernel's backward also at D = 64 and 128 (T = 70 and
   250), checks that the
   kernel's keep-mask is the plain version's bit for bit (rows numbered from
   0, and from 3 as a data-parallel rank's), then holds them
   against their plain versions once more and times them at the training
   path's shape (B=32, T=250, bf16, rate 0.1), and K4 and K5 again there in
   fp32 beside SDPA in fp32 (TF32 off);
7. trains the flagship model (attention_impl="pallas", bf16 over fp32
   parameters, attention_dropout 0.1, SpecAugment on) for 6 steps on seeded
   synthetic speech (B=32 of 9.3-10 s) through collator -> prefetch ->
   CTCTrainer(device="cuda").fit, evaluates, saves a checkpoint and the model
   directory, serves one request from it, and checks: finite losses, every
   step applied with its gradient norm under half the guard's threshold, the
   fixed batch's loss went down, 12 launches of each training kernel per step
   and 12 of the inference kernel per evaluation, the served request's
   logits and greedy ids equal to the plain path's on the trained weights,
   and step 1 equal to the same step with the plain attention versions;
8. builds the 176-wide shipped config (configs/ebranchformer_small_ctc.json at
   full size: 8 layers x 176, 4 heads of 44, I=704, conv_dim (176, 176),
   500+1 outputs; seeded random weights), whose heads the kernels take padded
   to 64 columns and whose q_rot to 192, and holds every kernel of a layer
   against its plain version at its B=8 x 10 s shapes (``layer_holds``, the
   routine step 13 runs too): the LayerNorm beside F.layer_norm, the seven
   GEMM calls of a layer with their epilogues (K = 176 or N = 176: edge
   tiles), each into a column slice of a guard buffer and beside F.linear,
   pos_query (pad columns zero; also at B=128), the attention (also at the
   2 s and 20 s buckets, lengths with 1 and 0), both depthwise convs at
   t_valid T, 1, T_pad and 0 beside F.conv1d(groups=C), the whole layer
   beside the sum of its pieces' bounds; K4 forward and its four gradients
   and K5 at dh 44 (``train_attention_holds``: T = 250 and 333, lengths with
   1 and 0, bf16 and fp32, rates 0 and 0.1), timed at B=32, T=250 beside
   SDPA;
9. serves that model through ASRPipeline(device="cuda"), which must take the
   fused path (the model's own front end, then the K1 layers), with requests
   of 1 and 8 utterances at 10 s and 20 s, each launching per layer one
   LayerNorm, 4 GEMMs with the LayerNorm prologue, 5 other GEMMs and one of
   each other K1 piece (14 launches), logits and greedy ids against the
   plain path (``serve_requests``, as step 13);
10. trains it 3 steps through CTCTrainer with the config's attention_impl
   ("auto"): 8 K4 forward and 8 K4 backward launches a step, every step
   applied, step 1 within 1e-4 in loss of the plain attention; then one
   evaluation step with "pallas" (8 K5 launches);
11. builds the joint CTC/attention model of configs/decred_base.json at full
   width (encoder 16 layers x 256, 8 heads, I=1024, 256x256 subsampler;
   decoder 6 layers x 256, 4 heads of 64, an intermediate head after layer 3
   with head weights 0.3/0.7; one vocabulary of 500 on both sides, bos/eos/pad
   0/1/3; seeded random weights), serves it through
   ASRPipeline(model_type="aed", device="cuda"), which must take the kernel
   route (K2 and 16 x K1 behind the plain log-mel front end), with B=8 x 10 s,
   5 beams, ctc_weight 0.3, max_length 128, and one more request with a seeded
   2-layer x 256 LM at lm_weight 0.3. It checks that every K1/K2 kernel
   launched in a request, that the kernel route's cross-attention state and
   CTC log-probs match the plain versions' (0.05 of scale) and that the n-best
   lists of the two routes are equal (where one differs, its score must be
   within bf16 noise of the other route's at that rank; the gap is printed);
   it prints the request time (median of 5 after a warm-up), decode steps,
   launches, device busy time under the profiler and its share of the
   window, peak memory, and the time of the encoder, the decoder steps and
   the CTC prefix scoring taken separately (each part synchronized);
12. drives the CTC command-line surface through ``cli/train_ctc.py::run`` and
   ``cli/evaluate.py::run`` (the card's machine has no ``datasets`` or
   ``transformers``: seeded synthetic corpus rows in memory, stand-in
   tokenizers whose ``decode`` writes the ids): train_ctc trains the flagship
   width (vocabulary 31, attention_impl "pallas": K4 in the train step, K5 in
   the evaluation step) from the Flax-matching initialiser, 8 steps at B=16
   with the JAX defaults (applied and rejected steps and each step's gradient
   norm printed; SpecAugment's caveat (b) may reject steps) and 4 steps with
   --no-apply_spec_augment (every step applied), each writing final/ and
   evaluating its test split; evaluate --model_type ctc on that final/ for 32
   utterances at batch 16, --fused_encoder on (K3, K2, K1) and off (the plain
   bf16 model), the two routes' logits held as in step 5, with wall time and
   RTFx; the committed gate model (huggingface_asr_tpu_torch/assets/gate_ctc,
   trained by the JAX CLIs) on its 64 test utterances, whose kernel route's
   ids must equal the JAX evaluate CLI's bf16 ids but for ties by the triage
   rule (a top-two logit gap within 2^-7 of the logit scale at the first
   frame that leaves JAX's; the plain routes' counts are printed); and
   evaluate --model_type aed with --save_nbest on the step-11 model (5 beams,
   ctc_weight 0.3, max_length 32, 8 utterances), whose best hypotheses must
   equal generate_joint's on the same features. Every kernel of these paths
   must launch in them.
13. builds the 512-wide shipped config (configs/ebranchformer_90m_ssl.json at
   full width: 17 layers x 512, 8 heads of 64, I=2048, conv_dim (512, 512);
   seeded random weights, 500+1 outputs) and holds its layer's kernels as in
   step 8: the LayerNorm at 512, the GEMM at N and K of 512, 1,024, 1,536
   and 2,048, pos_query at q_rot 512, the attention at q_rot 512 (the k_std
   chunk ring) beside SDPA on the 576-wide concatenated head, the CSGU conv
   (128-channel slices) and the merge conv at 1,024 channels; K4 forward and
   its four gradients at (dh 64, q_rot 512) in bf16 and fp32 and K5 at dh 64,
   timed at the BEST-RQ step's B=32, T=250 beside SDPA (fp32 K4 also at
   B=16, and K5 in fp32, beside SDPA in fp32), fp32 K4 at a padded head and
   q_rot ((40, 312) -> (64, 320), T=70, lengths 70, 1, 0), the fp32 time at
   q_rot 256 as a reference, the fp32 kernel's keep-mask read out of it at
   q_rot 512 against the plain version's; then serves four requests of
   8 x 10 s through ASRPipeline(model_type="ctc") as in step 9, the greedy
   ids also equal on at least 98 % of the valid frames; and pretrains it through cli/pretrain.run (BEST-RQ, codebook
   8192, B=16 x 9.3-10 s, bf16, attention_impl "pallas"): 3 steps, every one
   applied (K4 forward and backward and the backward's dq_rot GEMM 17 times a
   step), one evaluation batch (K5 17 times), final/ written, and step 1
   again with the plain attention within 1e-4 of its loss. Then the fp32
   training paths (``fp32_wide_phase``): BEST-RQ through cli/pretrain.run
   with --dtype float32 and the config's own attention_impl ("auto"), 3
   steps at B=16 x 9.3-10 s, every one applied with 17 K4 forward and 17 K4
   backward launches (the fp32 kernels of rel_attention_train.cu at q_rot
   512), the CLI's evaluation, step 1 again with the plain attention within
   1e-4 of its loss and 1e-3 of its gradient norm, one evaluation batch of
   the trained weights with "pallas" (17 K5 launches, fp32; its host time and
   K5's device time in it printed); then
   ``train_ctc.run --from_pretrained`` of that ``final/`` in fp32, 2 steps,
   each applied with 17 K4 forward and 17 backward launches; each step's
   host-clock time, K4's device time in a BEST-RQ step (profiler) and the
   runs' peak memory printed. The JSON line gains the fp32 rows
   (``rel_attention_train_{fwd,bwd}_fp32`` at the flagship's shape, step 6,
   ``rel_attention_train_{fwd,bwd}_q512_fp32`` at B=16 and ``_b32``,
   ``rel_attention_shift_dh64_fp32``, and ``rel_attention_shift_fp32``: K5 in
   fp32 at the flagship's shape, step 6, beside SDPA in fp32 on the 288-wide
   head) with the BEST-RQ run's launches and
   ``fp32_finetune_launches``.
14. right after step 11, trains that joint model (configs/decred_base.json at
   full width, vocabulary 500) from the Flax-matching initialiser through
   ``cli/train_aed.py::run`` (in-memory corpus rows of seeded synthetic speech
   and seeded label rows, a stand-in tokenizer): 6 steps at B=32 x 9.3-10 s,
   bf16 over fp32 weights, attention_impl "pallas" (config override), no
   SpecAugment (caveat (b)); every step applied with 16 K4 forward and 16 K4
   backward launches; one evaluation step (16 K5 launches); ``final/``; the
   final joint decode of an 8-utterance test split (5 beams, ctc_weight 0.3,
   max_length 32) on K2 + K1 with n-best lists written; step 1 again with the
   plain attention, loss within 1e-4 and gradient norm within 1e-3; then three
   ``cli/train_clm.py::run`` steps of a 6 x 256 LM on seeded text, and
   ``cli/evaluate.py::run --model_type aed --lm_model`` at lm_weight 0.3 on the
   trained model (the LM's score component non-zero, K1/K2 launched). It
   prints each step's losses, time, launches and the peak memory beside the
   card's name and power limit.
15. right after step 13, the rest of SSL: (a) wav2vec2 contrastive
   pretraining of configs/ebranchformer_30m_ssl.json at full width (12 x
   256, 8 heads; the quantizer's G=2 x V=320 codes of 256 columns, 100
   negatives; mask prob 0.65, length 10) through ``cli/pretrain.run`` at
   B=16 x 9.3-10 s, bf16, attention_impl "pallas": 3 steps, every one
   applied with a finite loss, one evaluation batch, exactly 36 K4 forward,
   36 K4 backward and 12 K5 launches, ``final/`` written, and step 1 again
   with the plain attention and the same Gumbel draw within 1e-4 in loss
   (step times, peak memory, contrastive and diversity losses printed);
   (d) ``train_ctc.run --from_pretrained`` of that ``final/`` refused with an
   error that names ``masked_spec_embed``, as the JAX CLI refuses it; (b)
   ``train_ctc.run --from_pretrained`` of step 13's BEST-RQ ``final/`` with
   both fine-tuning adapters (``--config_overrides``) and without them, 3
   steps each at B=16 x 9.3-10 s (vocabulary 31, no SpecAugment): the
   encoder at step 0 equal to the checkpoint's bit for bit, every step
   applied, 51 K4 forward and 51 K4 backward launches (the additional layer
   takes the plain attention, as in JAX); (c) both fine-tuned ``final/``s
   served through ``ASRPipeline(device="cuda")``, two requests of 8 x 10 s
   each: without adapters the fused route (the log-mel kernel, the model's
   own 512 x 512 front end, 17 layers of K1 pieces, counted per request) and
   greedy ids equal to the plain bf16 route's on at least 98 % of the valid
   frames; with adapters the plain route, the logged refusal naming the
   adapter, 17 K5 launches a request. Each kernel entry of the JSON line
   gains ``ssl_launches``, its launches in this step.
16. last, the recipe families at the published widths of
   ``openai/whisper-small.en`` (12 x 768, 12 heads, FFN 3072, 80 mel bins,
   1,500 source and 448 target positions, vocabulary 51,864) and GPT-2 small
   (12 x 768, 12 heads, 1,024 positions, vocabulary 50,257), from seeded
   weights drawn as HF initialises them (``reference_init_``) and loaded
   through ``--from_pretrained``, bf16 over fp32 weights, stand-in tokenizers
   and label rows of 100-150 ids: (a) ``train_ctc.run --model_family
   whisper_ctc`` 3 steps at B=16 x 9.3-10 s, every step applied; ``evaluate.run
   --model_type whisper_ctc`` on its ``final/`` (B=8 x 10 s) with
   ``--fused_encoder on`` (one mel and one cmvn launch a batch) and ``off``
   (none); the two routes' CTC logits within 0.05 of scale and their greedy ids
   equal on >= 98 % of the valid frames; a ``learnable_blank_head`` model 2
   steps, its frozen vocabulary kernel bit-equal after them; (b)
   ``train_aed.run --model_family whisper`` 3 steps at B=16 with forced ids,
   then ``generate_whisper`` on its ``final/`` at B=8 x 10 s, 5 beams,
   max_length 32, two forced ids and 200 suppressed tokens: no suppressed
   token in any hypothesis, every forced position held, ms a decode step; (c)
   ``train_ctc.run --model_family llm_asr`` 2 steps at B=8 (16 soft prompts,
   ctc_weight 0.3), ``evaluate.run --model_type llm_asr`` (16 greedy tokens)
   through both front ends, and the first-step LLM logits of the two front
   ends within 0.05 of scale under one CTC plan that keeps every valid frame.
   Each kernel entry of the JSON line gains ``recipe_launches``, its launches
   on these decode routes.
17. last, the E-Branchformer variants, the streaming sessions and the CTC
   beam search: (a) the flagship with a gated conv front end and the CSGU
   linear after the conv (seeded weights) serves B=8 x 10 s through
   ``ASRPipeline`` on the kernel route (K3, the model's own gated front end in
   bf16, then every layer's K1 pieces with the ungated CSGU conv and the GEMM's
   gate epilogue, 12 launches of each), three requests counted and five timed,
   logits and greedy ids against the plain path (0.05 of scale, ids equal at
   clear margins and on >= 98 % of valid frames with near-ties by the triage
   rule counted as ties, beside the plain layers' own agreement between the
   two front ends' features); the two new pieces against
   their plain versions at B=8 and B=128 beside their bounds, ``F.conv1d``
   and ``F.linear``, with device times, the ungated conv bit-equal to the gated
   form where x_r is 1; (b) two ``CTCTrainer`` steps of that model under
   attention_impl "auto" (12 K4 forward and backward launches a step), step 1
   within 1e-4 in loss of the plain attention; (c) the flagship with rotary
   positions, one B=8 request on the plain route (no kernel), its bf16 logits
   within 0.05 of scale of the fp32 model's; (d) ``StreamingCTCSession`` on a
   causal flagship (fp32) behind a global-CMVN front end, 10 s in 1 s feeds:
   every feed extends the last but at near-ties by the triage rule, the last
   equals a one-shot decode, ms a feed; (e) ``StreamingJointSession`` on
   ``decred_base.json`` with a causal encoder (fp32), three 2 s feeds, the last
   equal to ``generate_joint`` on the whole audio; (f) ``ctc_beam_search``
   (W=10, K=16) on (a)'s log-probs on the card against the same call on the
   CPU: n-best ids equal, scores within 1e-3, ms printed. The JSON line gains
   the two new pieces' rows (``dwconv_csgu_conv``, ``gemm_gate``, each also at
   B=128 / M = 32,768) with their launches in (a)'s request.
18. last, the tools and data parallelism (``tools_phase``): (a)
   ``cli/compute_dataset_statistics.run`` over 64 seeded utterances of 2-15 s
   in batches of 16 on K3's log-mel kernel (4 launches, no CMVN), its means
   and stds within twice the fp32 plain log-mel's largest error of the
   statistics of the same rows through the plain version in fp64 (the kernel's
   fp64 gate holds each log-mel value within that, and a mean or a std moves
   by no more); (b) ``train_ctc.run`` on the flagship (vocabulary 31,
   attention_impl "pallas", dropout on, no SpecAugment), 3 steps of 32 x
   9.3-10 s with an evaluation, twice without a process group, then under a
   one-rank NCCL group that the phase sets up (torchrun's variables, a free
   local port) with ``--fsdp`` off and on: every step applied, 36 K4 forward
   and 36 K4 backward launches and K5 in the evaluation each run, step 1's
   loss bit-equal in all four, and each step's loss and gradient norm of the
   group runs within the larger of the two runs' spread and 8 fp32 ulps (the
   CUDA backward of ``F.ctc_loss`` adds with atomics); (c) ``TrainerConfig.profile_steps
   = 2`` on a flagship ``CTCTrainer`` (32 x 10 s): the trace names K4's
   forward and backward kernels and a GEMM; (d) the native collator built by
   g++ under ``build/torch_native`` and in use; (e) ``build_hub_repo`` from
   (b)'s ``final/``, its weights loaded back strictly giving the same logits.
   Each kernel entry of the JSON line gains ``stats_cli_launches`` and
   ``process_group_launches``, its launches in (a) and in (b)'s group runs.
19. last, the serving numeric profile (``serving_phase``; the pipelines of
   steps 4, 7, 9, 13, 15 and 17(a) pass ``numeric_profile="exact"``, the
   contract their checks name; steps 9, 13 and 17(a) then serve one request
   in "serving" too, its serving kernels counted and held against the plain
   path of that profile): (a) K3's bf16 and high DFT modes
   (``csrc/mel_bf16.cu``) at B=8 and 128 x 10 s against their plain versions
   (1e-3 of the log-mel's scale), beside their bound, the fp32 kernel's time
   and cuBLAS's bf16 product of the same framed operands, with device times
   and each mode's largest log-mel error against the folded product in fp64
   beside the plain version's in the same mode and the fp32 one's (the
   kernel's at most 1.25x the plain version's of its mode); (b) the
   serving pieces at the B=8 x 10 s request's shapes, each beside its exact
   form's time: conv1 (bit-equal to its plain version, also at B=128), conv2,
   the GEMM's serving GELU epilogue (also at M = 32,768), rel_attention's
   serving normaliser, the whole layer; a ``MelFrontEnd(matmul_precision=
   "high")`` call's launches; (c) step 4's requests through ``ASRPipeline``
   with ``numeric_profile`` "exact" and then "serving" (the default), each
   launching only its own profile's kernels and held against the plain path
   of its profile; (d) the transcript gate: the committed gate model's 64
   test utterances in requests of 16 through ``ASRPipeline(model_type="ctc")``
   in "serving", whose ids must be the JAX serving composition's
   (``jax_reference.json``'s "serving") but for ties by the triage rule (the
   count in "exact" against the JAX bf16 model's ids is printed). The JSON
   line gains the serving kernels' rows with their launches in (c)'s serving
   requests, and the high mode's with the launches of its front-end call.
20. last, K3 past 80 mel bins and at a count that is no multiple of 8
   (``mel_bins_phase``, 23 and 128 bins): (a) the log-mel kernel in
   "highest" and "bf16" and the CMVN kernel at B=8 and 128 x 10 s against
   their plain versions (1e-4, 1e-3 and 2^-7 of the scale; CMVN on every
   column but the 128-bin bank's empty filter 3, reference caveat (k), whose
   values on each side are printed), the fp64 gates of (19a) and the "exact"
   contract, beside the cuBLAS product of the same framed operands and
   device times; (b) the flagship at that count, seeded weights, through
   ``ASRPipeline`` in "exact" and "serving": four requests, each launching
   one log-mel and one CMVN kernel and 12 x K1 behind the model's own conv
   front end (K2 takes 80 bins only), held against the plain path by
   ``against_plain_path`` with the caveat (k) rule (``empty_column_rule``),
   greedy ids on >= 98 % of the compared frames with near-ties by the
   triage rule as ties (seeded random weights give flat logits: 96.1 % raw
   at 128 bins in "exact").
   (c) the bf16 kernel in "bf16" and "high" at 1-11 mel bins, whose Kaldi
   banks (but 8's) have filters over more than two passes of 64 bins (summed
   in segments through carry slots), at B=8 and, at 10, B=128: against the
   plain version (1e-3 of the scale) and fp64 (at most 1.25x the plain
   version's error in both modes, as at 23 bins), beside the cuBLAS bf16
   product, each count's ``MelFrontEnd`` called once (one log-mel and one CMVN launch); then the
   flagship at 10 bins through ``ASRPipeline`` as in (b).
   The JSON line gains the rows ``mel_m23``, ``mel_bf16_m23``, ``cmvn_m23``
   (and ``_b128``, and the same at 128) with their launches in (b), and
   ``mel_bf16_m<n>``, ``mel_high_m<n>`` for n = 1-11 (and ``_b128`` at 10)
   with their ``MelFrontEnd`` call's launches (the 10-bin "bf16" rows: its
   serving requests').

Beside each kernel's time it prints the plain version's, the least time the
card could take (the larger of bytes / 3.35 TB/s and operations / the peak
rate of their type) and, where one PyTorch call computes the same function,
that call's time. It prints one JSON line with every kernel's launches
(and ``cli_launches``, its launches in step 12, and ``aed_train_launches``,
those of step 14's ``train_aed`` run), error, times and bound, then
the result line {"ok": true, "device": {...}}
last. It exits non-zero without a result line when CUDA is missing or any
phase fails.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): device memory bytes/s, bf16 tensor
# core FLOP/s, fp32 FLOP/s outside the tensor cores.
PEAK_BYTES, PEAK_FLOPS = 3.35e12, {"bf16": 989e12, "fp32": 67e12}


def bound(flops: float, nbytes: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def mel_work(wav, n_frames: int, dft, mel):
    """(operations, bytes, type) of the log-mel kernel: the framed DFT and
    the mel product in fp32, the mel product over the bank's nonzero weights
    (501 of 256 x 80 in the Kaldi bank: no implementation has to multiply
    by the zeros); the waveform, bases and log-mel moved once."""
    B = wav.shape[0]
    flops = 2.0 * B * n_frames * (dft.shape[0] * dft.shape[1] + int((mel != 0).sum()))
    return flops, nbytes(wav, dft, mel) + 4 * B * n_frames * mel.shape[1], "fp32"


def mel_errors(K3, wav, n_frames, frontend, cfg):
    """(kernel, fp32 plain version) largest log-mel errors against the same
    folded product in fp64 (the plain version on float64 operands)."""
    args = (cfg.hop_length, cfg.mel_floor)
    exact = K3.log_mel_plain(wav.double(), n_frames, frontend.dft.double(), frontend.mel.double(), *args)
    got = K3.log_mel(wav, n_frames, frontend.dft, frontend.mel, *args)
    plain = K3.log_mel_plain(wav, n_frames, frontend.dft, frontend.mel, *args)
    return float((got.double() - exact).abs().max()), float((plain.double() - exact).abs().max())


def conv1_bit_equal(K2, feats, w) -> float:
    """Share of conv1's outputs whose bits equal the plain version's."""
    import torch

    got = K2.conv1(feats, w["w1"], w["b1"]).view(torch.int16)
    return float((got == K2.conv1_plain(feats, w["w1"], w["b1"]).view(torch.int16)).float().mean())


def sum_bound(pieces):
    """The bound of a chain of kernels: the sum of its pieces' bounds, each
    piece (operations, bytes moved, type of the operations); bound by what
    bounds most of that sum."""
    parts = [bound(*p) for p in pieces]
    by_bytes = sum(ms for ms, by in parts if by == "bytes")
    total = sum(ms for ms, _ in parts)
    return total, "bytes" if 2 * by_bytes >= total else "operations"


def gemm_work(M: int, K: int, N: int, extra_bytes: int = 0):
    """(operations, bytes, type) of one bf16 GEMM: a, w, fp32 bias and the
    output once each, plus ``extra_bytes`` (a residual, a second output)."""
    return 2.0 * M * K * N, 2 * M * K + 2 * K * N + 4 * N + 2 * M * N + extra_bytes, "bf16"


def ln_gemm_work(M: int, K: int, N: int, extra_bytes: int = 0):
    """(operations, bytes, type) of one GEMM with the LayerNorm in its operand
    prologue: ``gemm_work``'s, plus g and b once and the LayerNorm's 8
    operations a value (the product's type sets the rate: they are 0.1-0.4 %
    of its operations); the normalised rows are never moved."""
    flops, moved, kind = gemm_work(M, K, N, extra_bytes)
    return flops + 8.0 * M * K, moved + 8 * K, kind


def layer_work(M: int, D: int, I: int, Cg: int, work_ln, work_pos_query, work_attention, work_csgu, work_merge):
    """The bound's pieces of the layer's 14 launches, in order: the four
    LayerNorms that feed a product in the GEMMs' prologues, the final one
    alone."""
    return [
        ln_gemm_work(M, D, I), gemm_work(M, I, D, 2 * M * D),                   # FF1 (+ residual)
        ln_gemm_work(M, D, 3 * D, 2 * M * D), work_pos_query, work_attention,    # attention (+ q_v)
        gemm_work(M, D, D),                                                     # out projection
        ln_gemm_work(M, D, 2 * Cg), work_csgu, gemm_work(M, Cg, D),             # cgMLP
        work_merge, gemm_work(M, 2 * D, D, 2 * M * D),                          # merge (+ residual)
        ln_gemm_work(M, D, I), gemm_work(M, I, D, 2 * M * D), work_ln,          # FF2, final LayerNorm
    ]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Seeded synthetic speech at 16 kHz: two-formant tone bursts of 80-160 ms
    with pauses, a random gain and a little noise."""
    n = int(seconds * 16000)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        dur = int(rng.uniform(0.08, 0.16) * 16000)
        t = np.arange(dur) / 16000
        seg = np.zeros(dur)
        if rng.random() > 0.15:
            f1, f2 = rng.uniform(300, 1200), rng.uniform(1200, 3500)
            seg = (0.6 * np.sin(2 * np.pi * f1 * t) + 0.4 * np.sin(2 * np.pi * f2 * t)) * np.hanning(dur)
        m = min(dur, n - pos)
        out[pos:pos + m] = seg[:m]
        pos += dur
    noise = rng.standard_normal(n).astype(np.float32) * 0.02
    return (out * rng.uniform(0.5, 1.0) + noise).astype(np.float32)


def flagship_config(**overrides):
    """The flagship E-Branchformer CTC: 12 layers, D=256, 8 heads, I=1024,
    256x256 subsampler, 500+1 outputs."""
    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig

    return EBranchformerConfig(**{**dict(
        hidden_size=256, num_hidden_layers=12, num_attention_heads=8, intermediate_size=1024,
        conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
        vocab_size=500,
    ), **overrides})


# The 176-wide shipped config: 8 layers x 176, 4 heads of 44, I=704, conv_dim
# (176, 176) (outside the subsampler kernel), 500 + 1 outputs.
SMALL_CONFIG = "ebranchformer_small_ctc.json"
# The 512-wide shipped config: 17 layers x 512, 8 heads of 64, I=2048,
# conv_dim (512, 512) (outside the subsampler kernel), BEST-RQ codebook 8192.
WIDE_CONFIG = "ebranchformer_90m_ssl.json"


def config_file(name: str):
    """A config file under configs/ (an encoder-decoder file's encoder)."""
    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig

    with open(os.path.join(ROOT, "configs", name)) as f:
        d = json.load(f)
    return EBranchformerConfig.from_dict(d.get("encoder", d))


def seeded_model(cfg, seed: int = 0):
    """An E-Branchformer CTC model of ``cfg`` with weights of useful scale drawn from ``seed``."""
    import torch

    from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_random_

    return init_random_(EBranchformerForCTC(cfg).eval(), torch.Generator().manual_seed(seed))


def flagship_model(seed: int = 0):
    """The flagship model with weights of useful scale drawn from ``seed``."""
    return seeded_model(flagship_config(), seed)


def training_setup(seed: int = 0, batch_size: int = 32, n_batches: int = 6, checkpoint_dir=None, cfg=None):
    """The training phase's trainer and host batches: the flagship model with
    the training attention kernels selected (or a model of ``cfg``), seeded
    random weights at a from-scratch trainer's scale (matrices ~ N(0,
    initializer_range^2)), bf16 compute, SpecAugment on; batches of
    ``batch_size`` seeded synthetic utterances of 93-100 % of 10 s with seeded
    label sequences. The learning rate is small on purpose. A from-scratch CTC
    model first learns to emit blanks, and on the way its gradient norm climbs
    towards the trainer's guard (steps at 100 or more are rejected): the
    faster the loss falls, the sooner. A smoke run's few steps are to be
    applied, with room to spare."""
    import torch

    from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig
    from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
    from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
    from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC, init_random_
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
    from huggingface_asr_tpu_torch.training.loop import CTCTrainer, TrainerConfig
    from huggingface_asr_tpu_torch.training.optim import OptimizerConfig

    cfg = cfg or flagship_config(attention_impl="pallas", attention_dropout=0.1)
    model = init_random_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(seed),
                         matrix_std=cfg.initializer_range)
    tcfg = TrainerConfig(
        optimizer=OptimizerConfig(learning_rate=5e-6, warmup_steps=2, total_steps=1000),
        max_steps=n_batches, log_every=1, save_every=10 ** 9, seed=seed, checkpoint_dir=checkpoint_dir,
    )
    trainer = CTCTrainer(model, tcfg, frontend=LogMelFrontEnd(LogMelConfig(num_mel_bins=cfg.num_fbanks)),
                         device="cuda", dtype="bfloat16")
    rng = np.random.default_rng(seed)
    collate = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(batch_size=batch_size, buckets=(160000,))))
    batches = []
    for _ in range(n_batches):
        examples = []
        for _ in range(batch_size):
            wav, _ = utterance(rng.uniform(9.3, 10.0), rng)
            examples.append({"audio": wav, "labels": rng.integers(0, 500, rng.integers(20, 41)).tolist()})
        batches.append(collate(examples))
    return trainer, batches


# The joint CTC/attention config of the AED phase. The file sets no vocabulary
# (the JAX CLI fills it from the tokenizer on both sides); the smoke sets 500
# on both sides, with bos/eos/pad 0/1/3 as the JAX CLI's tokenizers have them.
AED_CONFIG = "decred_base.json"
AED_VOCAB = 500


def aed_config():
    """The joint config of ``AED_CONFIG`` with the smoke's vocabulary and special ids."""
    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig

    with open(os.path.join(ROOT, "configs", AED_CONFIG)) as f:
        d = json.load(f)
    d["encoder"]["vocab_size"] = AED_VOCAB
    d["decoder"].update(vocab_size=AED_VOCAB, bos_token_id=0, eos_token_id=1, pad_token_id=3)
    return JointCTCAttentionConfig.from_dict({**d, "decoder_start_token_id": 0, "pad_token_id": 3})


def aed_model(seed: int = 0, cfg=None):
    """The joint model of ``AED_CONFIG`` (or ``cfg``) with seeded random weights."""
    import torch

    from huggingface_asr_tpu_torch.models.ebranchformer import init_random_
    from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder

    cfg = cfg or aed_config()
    return init_random_(JointCTCAttentionEncoderDecoder(cfg).eval(), torch.Generator().manual_seed(seed))


class AedPieces:
    """id -> piece decoding for the random joint model's 500 ids, with the
    special ids an HF tokenizer has (bos/eos/pad 0/1/3)."""

    bos_token_id, eos_token_id, pad_token_id, unk_token_id = 0, 1, 3, 2

    def __len__(self):
        return AED_VOCAB

    def decode(self, ids, skip_special_tokens=True):
        ids = [i for i in ids if not (skip_special_tokens and i in (0, 1, 2, 3))]
        return "".join(chr(ord("a") + i % 26) if i % 7 else " " for i in ids)


def rescore_hypotheses(model, enc, hid, hyps, cfg):
    """Teacher-forced scores of fixed hypotheses under one encoder output, with
    the beam search's accounting: per step (1 - ctc_weight) * the decoder's
    log-prob + ctc_weight * the CTC prefix score's increment (pad never,
    blank never), summed up to and including eos, over (t + 1) ** penalty
    where eos came at step t (or max_length ** penalty for a hypothesis
    without eos). ``hyps`` (B, H, L) starts with bos. Returns (scores (B, H),
    per-step combined scores (B, H, L - 1), zero past the last token)."""
    import torch
    import torch.nn.functional as F

    from huggingface_asr_tpu_torch.decoding.beam_search import NEG_INF
    from huggingface_asr_tpu_torch.decoding.ctc_prefix import CTCPrefixScorer

    B, Hn, L = hyps.shape
    toks = hyps.reshape(B * Hn, L)
    V = model.config.decoder.vocab_size
    is_eos = toks[:, 1:] == cfg.eos_token_id
    has_eos = is_eos.any(dim=1)
    last = torch.where(has_eos, is_eos.int().argmax(dim=1), L - 2)  # the step of the last scored token
    lp_len = torch.where(has_eos, last + 1, L).float() ** cfg.length_penalty
    lens = enc.logit_lengths.repeat_interleave(Hn)
    att = F.log_softmax(model.decoder(toks[:, :-1], model.project(hid).repeat_interleave(Hn, 0), lens)
                        .logits.float(), dim=-1)[..., :V]
    att[..., cfg.pad_token_id] = NEG_INF
    att = att.gather(-1, toks[:, 1:, None])[..., 0]
    lp = F.log_softmax(enc.logits.float(), dim=-1)
    scorer = CTCPrefixScorer(lp, enc.logit_lengths, cfg.blank_id % lp.shape[-1], cfg.eos_token_id)
    state, ctc, rows = scorer.init_state(Hn), [], torch.arange(B * Hn, device=toks.device)
    for t in range(L - 1):
        tok = toks[:, t + 1]
        inc, scored = scorer.score_candidates(state, tok[:, None])
        ctc.append(inc[:, 0])
        state = scorer.select_state(state, scored, rows, torch.zeros_like(rows), tok)
    steps = (1.0 - cfg.ctc_weight) * att + cfg.ctc_weight * torch.stack(ctc, dim=1)
    steps = torch.where(torch.arange(L - 1, device=toks.device)[None, :] <= last[:, None], steps, 0.0)
    return (steps.sum(dim=1) / lp_len).view(B, Hn), steps.view(B, Hn, L - 1)


def aed_phase(dev, rng, smi) -> dict:
    """The joint CTC/attention serving path on the card (step 11 of the
    module's docstring). Returns the kernel launches of one request."""
    import dataclasses as dc

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from huggingface_asr_tpu_torch.decoding.beam_search import joint_beam_search
    from huggingface_asr_tpu_torch.decoding.generate import build_decoder_step, generate_joint
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.models.ebranchformer import init_random_
    from huggingface_asr_tpu_torch.models.fast_infer import ctc_infer
    from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig, GPT2MultiHeadDecoder
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    print(f"-- AED serving path: configs/{AED_CONFIG} at full width, vocabulary {AED_VOCAB} on both sides, "
          f"B=8 x 10 s, 5 beams, ctc_weight 0.3, max_length 128", flush=True)
    aed_dir = os.path.join(ROOT, "build", "chip_smoke_aed")
    save_params(aed_model(seed=3), aed_dir)
    pipe = ASRPipeline(aed_dir, model_type="aed", ctc_weight=0.3, num_beams=5, max_length=128, device="cuda",
                       tokenizer=AedPieces())
    if not pipe._use_fused:
        _fail("the AED pipeline did not select the kernel route for its encoder")
    model, gen_cfg = pipe._model, pipe._gen_cfg
    ecfg = model.config.encoder
    audios = [speech(10.0, rng) for _ in range(8)]
    texts = pipe(audios)  # first call: warm the allocator
    torch.cuda.synchronize()

    # one request, with the launch counts set to 0 just before it
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    texts = pipe(audios)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    per_layer = {"asr_gemm_bf16": 1, "asr_gemm_ln_bf16": 1, "asr_layernorm_bf16": 1, "asr_pos_query": 1,
                 "asr_rel_attention": 1, "dwconv_csgu": 1, "dwconv_merge": 1}
    missing = [k for k in ("asr_conv1", "asr_conv2", *per_layer) if launches.get(k, 0) <= 0]
    if len(texts) != 8 or missing or launches.get("asr_log_mel", 0) or launches.get("asr_rel_attention", 0) \
            != ecfg.num_hidden_layers:
        _fail(f"AED request: {len(texts)} transcripts, launches {launches}; not launched: {missing} "
              f"(want {ecfg.num_hidden_layers} rel_attention launches and no log-mel kernel)")
    print(f"  AED request launches: {launches} ({sum(launches.values())} kernel launches); transcripts: "
          f"{[t[:30] for t in texts]}", flush=True)

    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe(audios)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)

    # the request's parts, each synchronized: front end, encoder, decoder
    # steps, CTC prefix scoring, beam selection
    wav = torch.from_numpy(pipe._bucket_pad(audios)).to(dev)
    lens = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=dev)
    parts = {}
    clock = {"name": "front end", "t": 0.0}

    def hook(name, alive=None):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[clock["name"]] = parts.get(clock["name"], 0.0) + (now - clock["t"]) * 1e3
        clock.update(name=name, t=now)
        if name == "decoder":
            parts["steps"] = parts.get("steps", 0) + 1

    with torch.inference_mode():
        torch.cuda.synchronize()
        clock["t"] = time.perf_counter()
        feats, feat_lens = pipe._frontend(wav, lens)
        seqs, scores, comps = generate_joint(model, feats, feat_lens, dc.replace(gen_cfg, return_components=True),
                                             fused_encoder=True, fused=pipe._fused, hook=hook)
    steps = parts.pop("steps")
    print(f"  AED request: {float(np.median(ms)):.1f} ms (median of 5; all {[round(m, 1) for m in ms]}); "
          f"{steps} decode steps; peak memory {peak:.0f} MiB; {smi}", flush=True)
    print("  AED request parts, each synchronized (ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in parts.items() if k != "end")
          + f"; decoder {parts['decoder'] / steps:.3f} and CTC prefix {parts.get('ctc', 0.0) / steps:.3f} a step",
          flush=True)

    # device busy under the profiler, over one request's window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(audios)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    on_device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ev.time_range.end - ev.time_range.start for ev in on_device) / 1e3
    print(f"  AED request under the profiler: {len(on_device)} device kernels and copies, busy {busy:.2f} ms of a "
          f"{window:.1f} ms window ({100 * busy / window:.1f} %)", flush=True)

    # what comes out
    B, W, L = 8, gen_cfg.num_beams, gen_cfg.max_length
    s = scores.float()
    if tuple(seqs.shape) != (B, W, L) or not bool((seqs[:, :, 0] == 0).all()) \
            or not bool(torch.isfinite(s[:, 0]).all()) or not bool((s[:, :-1] + 1e-6 >= s[:, 1:]).all()):
        _fail(f"AED sequences {tuple(seqs.shape)} or scores out of order / not finite")

    # the kernel route against the plain versions, on the same features
    with torch.inference_mode():
        k_enc, k_hid = ctc_infer(pipe._fused, feats, feat_lens, return_hidden=True)
        p_enc, p_hid = ctc_infer(pipe._fused, feats, feat_lens, plain=True, return_hidden=True)
        k_x, p_x = model.project(k_hid), model.project(p_hid)
        k_lp, p_lp = F.log_softmax(k_enc.logits.float(), -1), F.log_softmax(p_enc.logits.float(), -1)
    if not torch.equal(k_enc.logit_lengths, p_enc.logit_lengths):
        _fail("AED encoder lengths differ between the kernel route and the plain versions")
    valid = torch.arange(k_lp.shape[1], device=dev)[None, :] < p_enc.logit_lengths[:, None]
    for name, g, r in (("cross-attention state", k_x.float(), p_x.float()), ("CTC log-probs", k_lp, p_lp)):
        err, scale = float((g - r).abs()[valid].max()), float(r.abs()[valid].max())
        tol = 0.05 * max(1.0, scale)
        print(f"  AED {name}, kernels vs plain versions: max_abs_err={err:.3e} tol={tol:.3e} (scale {scale:.3f})",
              flush=True)
        if not bool(torch.isfinite(g).all()) or err > tol:
            _fail(f"AED {name}: the kernel route disagrees with the plain versions")

    def search(enc, hid, alive):
        """The search on one route's encoder outputs; ``alive`` collects the
        alive tokens each step starts from."""
        step, cache = build_decoder_step(model.decoder, B * W, L, model.project(hid), enc.logit_lengths)
        return joint_beam_search(step, cache, B, gen_cfg, ctc_log_probs=F.log_softmax(enc.logits.float(), -1),
                                 ctc_lengths=enc.logit_lengths, vocab_size=model.config.decoder.vocab_size,
                                 hook=lambda name, a=None: alive.append(a.clone()) if name == "decoder" else None)

    k_alive, p_alive = [], []
    with torch.inference_mode():
        (k_seqs, k_scores), (p_seqs, p_scores) = search(k_enc, k_hid, k_alive), search(p_enc, p_hid, p_alive)
    if not torch.equal(k_seqs, seqs):
        _fail("the composed search on the kernel route's outputs differs from generate_joint's")
    differ = (k_seqs != p_seqs).any(-1)
    with torch.inference_mode():
        own = rescore_hypotheses(model, k_enc, k_hid, k_seqs[:, :1], gen_cfg)[0][:, 0]
    own = float(((own - k_scores[:, 0]).abs() / k_scores[:, 0].abs().clamp(min=1.0)).max())
    print(f"  AED n-best, kernel route vs plain versions: {int((~differ).sum())}/{B * W} entries equal, the best "
          f"equal in {int((~differ[:, 0]).sum())}/{B}; teacher-forced rescoring reproduces the search's best "
          f"scores within {own:.2e} of their size", flush=True)
    if own > 1e-2:
        _fail("AED: teacher-forced rescoring does not reproduce the search's scores")

    # The triage rule for near-ties, at the first step where the two searches'
    # alive sets differ: both entered the step that made them with the same
    # hypotheses, and each kept some the other dropped. Under the plain
    # route's totals (teacher-forced, the search's own accounting), the gap
    # between the lowest it kept and the highest it dropped that the kernel
    # route kept must be at bf16 noise: at most 2^-7 of the total. It must not
    # be negative beyond that either: a hypothesis the plain search dropped
    # that outscores one it kept means the totals and the search disagree.
    # Beams re-rank after that step, so later differences follow from this one.
    ka, pa = torch.stack(k_alive).cpu().numpy(), torch.stack(p_alive).cpu().numpy()  # (steps, B, W, L)
    pad = gen_cfg.pad_token_id
    rows = torch.full((B, 2 * W, L), pad, dtype=torch.int64)
    rows[:, :, 0] = gen_cfg.bos_token_id
    flips = {}
    for b in range(B):
        for t in range(1, min(len(ka), len(pa))):
            kset, pset = ({tuple(r[:t + 1]) for r in x[t, b]} for x in (ka, pa))
            if kset != pset:
                X, Y = sorted(kset - pset), sorted(pset - kset)
                for i, r in enumerate(X + Y):
                    rows[b, i, :t + 1] = torch.tensor(r)
                flips[b] = (t, len(X), len(Y))
                break
    if flips:
        with torch.inference_mode():
            hyps = rows.to(dev)
            _, on_k = rescore_hypotheses(model, k_enc, k_hid, hyps, gen_cfg)
            _, on_p = rescore_hypotheses(model, p_enc, p_hid, hyps, gen_cfg)
    for b in range(B):
        if b not in flips:
            if bool(differ[b, 0]):
                _fail(f"AED utterance {b}: the best hypotheses differ but the alive sets never did")
            continue
        t, nx, ny = flips[b]
        tot_p, tot_k = (x[b, :, :t].sum(-1) for x in (on_p, on_k))  # totals entering step t
        x_star = int(tot_p[:nx].argmax())
        y_star = nx + int(tot_p[nx:nx + ny].argmin())
        gap = float(tot_p[y_star] - tot_p[x_star])
        bound = 2 ** -7 * max(1.0, abs(float(tot_p[y_star])))
        moved = float((tot_k[x_star] - tot_p[x_star]).abs() + (tot_k[y_star] - tot_p[y_star]).abs())
        print(f"    utterance {b}: alive sets first differ after step {t - 1} ({nx} kept by one route only); the "
              f"plain route's top-two gap there {gap:+.5f} of a total {float(tot_p[y_star]):.3f} (bound "
              f"{bound:.5f}); the route change moved those totals by {moved:.5f}", flush=True)
        if gap > bound:
            _fail(f"AED utterance {b}: the two routes' searches part beyond bf16 noise")
        if gap < -bound:
            _fail(f"AED utterance {b}: the plain search dropped a hypothesis that its own teacher-forced totals "
                  f"rank above one it kept (gap {gap:+.5f})")

    # one more request with a seeded 2-layer x 256 LM at lm_weight 0.3
    lm_cfg = GPT2DecoderConfig(vocab_size=AED_VOCAB, n_positions=512, n_embd=256, n_layer=2, n_head=4,
                               add_cross_attention=False, bos_token_id=0, eos_token_id=1, pad_token_id=3)
    lm = init_random_(GPT2MultiHeadDecoder(lm_cfg, dtype=model.dtype).eval(),
                      torch.Generator().manual_seed(4)).to(dev)
    lm_gen = dc.replace(gen_cfg, lm_weight=0.3, return_components=True)
    with torch.inference_mode():
        generate_joint(model, feats, feat_lens, lm_gen, lm=lm, fused=pipe._fused)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_seqs, lm_scores, lm_comps = generate_joint(model, feats, feat_lens, lm_gen, lm=lm, fused=pipe._fused)
        torch.cuda.synchronize()
    lm_ms = (time.perf_counter() - t0) * 1e3
    if tuple(lm_seqs.shape) != (B, W, L) or not bool(torch.isfinite(lm_scores[:, 0]).all()) \
            or not bool((lm_comps["lm"][:, 0] != 0).all()):
        _fail("the LM-fused AED request's output is malformed or its LM component is 0")
    print(f"  AED request with a 2 x 256 LM at lm_weight 0.3: {lm_ms:.1f} ms (after one warm-up); best "
          f"hypotheses changed by the LM in {int((lm_seqs[:, 0] != seqs[:, 0]).any(-1).sum())}/{B}", flush=True)
    return launches


def aed_train_phase(dev, smi) -> dict:
    """Joint CTC/attention training and the shallow-fusion LM on the card
    (step 14 of the module's docstring), through ``train_aed.run``,
    ``train_clm.run`` and ``evaluate.run`` with in-memory corpus rows and
    stand-in tokenizers. Returns the kernel launches of the ``train_aed`` run,
    by counter."""
    import torch

    from huggingface_asr_tpu_torch.cli import evaluate, train_aed, train_clm
    from huggingface_asr_tpu_torch.cli.common import tokenizer_ids
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train, rel_attention_train_plain
    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )
    from huggingface_asr_tpu_torch.training.loop import JointTrainer
    from huggingface_asr_tpu_torch.training.model_factory import load_aed_model

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_aed_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(14)
    tok = IdTokenizer(AED_VOCAB, specials=(0, 1, 2, 3))

    def split(n):
        audio = [speech(rng.uniform(9.3, 10.0), rng) for _ in range(n)]
        labels = [rng.integers(4, AED_VOCAB, rng.integers(20, 41)).tolist() for _ in range(n)]
        return ColumnTable({"audio": audio, "labels": labels, "text": [tok.decode(x) for x in labels],
                            "input_len": [len(a) / 16000 for a in audio]})

    data = {"train": split(64), "validation": split(32), "test": split(8)}
    n_layers = config_file(AED_CONFIG).num_hidden_layers
    print(f"-- AED training (cli/train_aed.run): configs/{AED_CONFIG} at full width, vocabulary {AED_VOCAB}, "
          f"B=32 x 9.3-10 s, bf16 over fp32 weights, attention_impl 'pallas' (K4 in the steps, K5 in the "
          f"evaluation), the Flax-matching initialiser, --no-apply_spec_augment", flush=True)
    model_args = ModelArguments(model_config=os.path.join(ROOT, "configs", AED_CONFIG), device="cuda",
                                dtype="bfloat16", config_overrides="encoder_attention_impl=pallas")
    training = GeneralTrainingArguments(output_dir=os.path.join(work, "aed"), per_device_train_batch_size=32,
                                        per_device_eval_batch_size=32, max_steps=6, logging_steps=1, eval_steps=6,
                                        save_steps=10 ** 9, warmup_steps=2, learning_rate=2e-4, seed=5,
                                        apply_spec_augment=False)
    gen = GenerationArguments(num_beams=5, ctc_weight=0.3, max_length=32, save_nbest=True)
    steps_seen = []
    real_step = JointTrainer.train_step

    def watched_step(self, state, batch):
        before = dict(_build.LAUNCHES)
        t_ = time.perf_counter()
        state, m = real_step(self, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_) * 1e3
        step_launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items() if v != before.get(k, 0)}
        steps_seen.append((dict(batch), {k: float(v) for k, v in m.items()}, ms, step_launches,
                           torch.cuda.max_memory_allocated() / 2 ** 30))
        return state, m

    JointTrainer.train_step = watched_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        results = train_aed.run(model_args, training, gen, DataConfig(), data, tok)
    finally:
        JointTrainer.train_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_launches = dict(_build.LAUNCHES)
    for i, (_, m, ms, sl, peak) in enumerate(steps_seen):
        print(f"  step {i + 1}: loss={m['loss']:.4f} enc_loss={m['enc_loss']:.4f} dec_loss={m['dec_loss']:.4f} "
              f"grad_norm={m['grad_norm']:.3f} applied={int(m['step_applied'])} {ms:.1f} ms (host clock, "
              f"synchronized); launches {sl}", flush=True)
    step_ms = [ms for _, _, ms, _, _ in steps_seen]
    with open(os.path.join(training.output_dir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/loss" in r]
    print(f"  train_aed: {len(steps_seen)} steps, step ms median {float(np.median(step_ms)):.1f} (steps 2-6: "
          f"{[round(x, 1) for x in step_ms[1:]]}), peak memory {max(p for *_, p in steps_seen):.2f} GiB; the run "
          f"(steps, evaluation, final/, joint decode of the test split) {wall:.1f} s; evaluation "
          f"{[{k: round(v, 4) for k, v in r.items() if k.startswith('eval/')} for r in evals]}; {smi}", flush=True)
    print(f"  train_aed run launches: {run_launches}", flush=True)
    if len(steps_seen) != 6 or not all(np.isfinite(m["loss"]) for _, m, *_ in steps_seen):
        _fail(f"train_aed: {len(steps_seen)} of 6 steps, or a loss is not finite")
    if not all(int(m["step_applied"]) == 1 for _, m, *_ in steps_seen):
        _fail("train_aed: the guard rejected a step")
    for i, (_, _, _, sl, _) in enumerate(steps_seen):
        for k in ("asr_rel_attention_train_fwd", "asr_rel_attention_train_bwd"):
            if sl.get(k, 0) != n_layers:
                _fail(f"train_aed step {i + 1}: {sl.get(k, 0)} launches of {k}, want {n_layers}")
    if len(evals) != 1 or run_launches.get("asr_rel_attention_shift", 0) != n_layers:
        _fail(f"train_aed: {len(evals)} evaluations, {run_launches.get('asr_rel_attention_shift', 0)} K5 launches "
              f"(want one evaluation step, {n_layers})")
    if any(run_launches.get(k, 0) <= 0 for k in ("asr_conv1", "asr_conv2", "asr_rel_attention")):
        _fail(f"train_aed: the final joint decode did not take the kernel route: {run_launches}")
    names = ("predictions_test.csv", "nbest_hyps.txt", "nbest_scores.txt", "nbest_att_scores.txt",
             "nbest_ctc_scores.txt", "nbest_lm_scores.txt")
    if "test" not in results or any(not os.path.exists(os.path.join(training.output_dir, n)) for n in names):
        _fail(f"train_aed: no test-split result or not all of {names} written")
    with open(os.path.join(training.output_dir, "nbest_hyps.txt")) as f:
        n_nbest = len(f.readlines())
    final = os.path.join(training.output_dir, "final")
    load_aed_model(final, dev, torch.bfloat16)  # strict
    print(f"  final joint decode (5 beams, ctc_weight 0.3, max_length 32): {results['test'].num_examples} test "
          f"utterances in {1e3 * results['test'].wall_time:.1f} ms, {n_nbest} n-best entries written", flush=True)

    # step 1 again from the same initial weights, streams and batch, with the plain attention
    twin_model = train_aed.build_model(model_args, train_aed.build_model_config(model_args, tokenizer_ids(tok)),
                                       training.seed)
    twin = JointTrainer(twin_model, train_aed.build_trainer_config(training), device="cuda", dtype="bfloat16",
                        frontend=LogMelFrontEnd(LogMelConfig(num_mel_bins=twin_model.config.encoder.num_fbanks)))
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = twin.train_step(twin.init_state(), steps_seen[0][0])
        if any(k.startswith("asr_rel_attention") and v != before.get(k, 0) for k, v in _build.LAUNCHES.items()):
            _fail("the plain-attention AED step launched an attention kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    m1 = steps_seen[0][1]
    d_loss = abs(m1["loss"] - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    d_norm = abs(m1["grad_norm"] - float(m_plain["grad_norm"])) / float(m_plain["grad_norm"])
    print(f"  AED step 1, kernels vs plain attention: loss {m1['loss']:.6f} vs {float(m_plain['loss']):.6f} (rel "
          f"{d_loss:.2e}, tol 1e-4); grad norm {m1['grad_norm']:.4f} vs {float(m_plain['grad_norm']):.4f} (rel "
          f"{d_norm:.2e}, tol 1e-3)", flush=True)
    if d_loss > 1e-4 or d_norm > 1e-3:
        _fail("AED step 1 with the attention kernels disagrees with the plain-attention step")
    del twin
    torch.cuda.empty_cache()

    # ---- train_clm: three steps of a 6 x 256 LM on seeded text
    letters = np.array(list(IdTokenizer.CHARS))
    texts = ["".join(rng.choice(letters, rng.integers(20, 60))) for _ in range(400)]
    clm_training = GeneralTrainingArguments(output_dir=os.path.join(work, "clm"), per_device_train_batch_size=16,
                                            per_device_eval_batch_size=16, max_steps=3, logging_steps=1,
                                            eval_steps=10 ** 9, save_steps=10 ** 9, warmup_steps=1,
                                            learning_rate=1e-3, seed=5)
    clm_args = train_clm.CLMArguments(block_size=128)
    clm_steps = []
    real_clm_step = train_clm.CLMTrainer.train_step

    def watched_clm_step(self, state, batch):
        t_ = time.perf_counter()
        state, m = real_clm_step(self, state, batch)
        torch.cuda.synchronize()
        clm_steps.append(({k: float(v) for k, v in m.items()}, (time.perf_counter() - t_) * 1e3))
        return state, m

    train_clm.CLMTrainer.train_step = watched_clm_step
    torch.cuda.reset_peak_memory_stats()
    try:
        clm_eval = train_clm.run(ModelArguments(device="cuda"), clm_training, clm_args, texts, texts[:40],
                                 IdTokenizer(AED_VOCAB))
    finally:
        train_clm.CLMTrainer.train_step = real_clm_step
    clm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (m, ms) in enumerate(clm_steps):
        print(f"  train_clm step {i + 1}: loss={m['loss']:.4f} ppl={m['ppl']:.1f} applied={int(m['step_applied'])} "
              f"{ms:.1f} ms", flush=True)
    print(f"  train_clm (6 x 256, B=16 x 128 tokens, fp32): step ms median "
          f"{float(np.median([ms for _, ms in clm_steps])):.1f}, peak memory {clm_peak:.2f} GiB; final evaluation "
          f"{clm_eval}; {smi}", flush=True)
    if len(clm_steps) != 3 or not all(np.isfinite(m["loss"]) and int(m["step_applied"]) == 1 for m, _ in clm_steps) \
            or not clm_eval or not os.path.exists(os.path.join(clm_training.output_dir, "final", "config.json")):
        _fail(f"train_clm: {len(clm_steps)} of 3 steps, a loss not finite or a step rejected, or no final/")

    # ---- evaluate --model_type aed --lm_model on the trained model at lm_weight 0.3
    ev_out = os.path.join(work, "eval_lm")
    ev_gen = GenerationArguments(num_beams=5, ctc_weight=0.3, max_length=32, save_nbest=True,
                                 lm_model=os.path.join(clm_training.output_dir, "final"), lm_weight=0.3)
    _build.reset_launch_counts()
    res = evaluate.run(evaluate.EvalArguments(output_dir=ev_out, batch_size=8, model_type="aed"),
                       ModelArguments(from_pretrained=final), ev_gen, DataConfig(), {"test": data["test"]}, tok)
    torch.cuda.synchronize()
    with open(os.path.join(ev_out, "nbest_lm_scores.txt")) as f:
        lm_scores = [float(line.split()[1]) for line in f]
    print(f"  evaluate --model_type aed --lm_model (6 x 256 LM, lm_weight 0.3): {res['test'].num_examples} "
          f"utterances in {1e3 * res['test'].wall_time:.1f} ms; LM score components {min(lm_scores):.3f} .. "
          f"{max(lm_scores):.3f}; launches {dict(_build.LAUNCHES)}", flush=True)
    if len(lm_scores) != 8 * 5 or not all(np.isfinite(s) and s < 0.0 for s in lm_scores):
        _fail("evaluate --lm_model: the LM's score components are missing, zero or not finite")
    if any(_build.LAUNCHES.get(k, 0) <= 0 for k in ("asr_conv1", "asr_conv2", "asr_rel_attention")):
        _fail(f"evaluate --lm_model did not take the kernel route: {dict(_build.LAUNCHES)}")
    print(f"AED training phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return run_launches


class IdTokenizer:
    """A stand-in tokenizer for the CLIs on the card (the card's machine has no
    ``transformers``): ``decode`` writes the ids themselves, separated by
    spaces, so the CLIs' CSV files carry them; ``encode`` is character level
    (ids 4.. for the space and the letters, eos after). ``specials`` are
    dropped by ``decode`` with ``skip_special_tokens`` (none: every id the
    decoder produced is written)."""

    bos_token_id, eos_token_id, unk_token_id, pad_token_id = 0, 1, 2, 3
    CHARS = " abcdefghijklmnopqrstuvwxyz"

    def __init__(self, vocab_size: int = 4 + len(CHARS), specials=()):
        self.vocab_size, self.specials = vocab_size, set(specials)

    def __len__(self):
        return self.vocab_size

    def encode(self, text):
        return [4 + self.CHARS.index(c) if c in self.CHARS else self.unk_token_id for c in text] + [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids if not (skip_special_tokens and int(i) in self.specials))


# The committed gate model (trained by the JAX CLIs; tests/test_torch_cli_gate.py)
GATE_DIR = os.path.join("huggingface_asr_tpu_torch", "assets", "gate_ctc")
TIE = 2.0 ** -7  # the triage rule: a top-two logit gap within this share of the logit scale is a tie


def _collapse(frame_ids, blank):
    out, prev = [], blank
    for t in frame_ids:
        if t != blank and t != prev:
            out.append(int(t))
        prev = t
    return out


def _csv_ids(path):
    import csv

    with open(path, newline="") as f:
        return [[int(t) for t in row["prediction"].split()] for row in csv.DictReader(f)]


def count_launches(fn, into: dict):
    """Run ``fn`` with the kernels' launch counts set to 0 just before; returns
    (its result, the counts read just after), which are also added into ``into``."""
    import torch

    from huggingface_asr_tpu_torch.kernels import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    for k, v in got.items():
        into[k] = into.get(k, 0) + v
    return out, got


def watch_steps(cls):
    """Record (batch, metrics, host ms) of each synchronized ``cls.train_step``;
    returns the list and the function that restores the method."""
    import torch

    seen, real = [], cls.train_step

    def step(self, state, batch):
        t_ = time.perf_counter()
        state, m = real(self, state, batch)
        torch.cuda.synchronize()
        seen.append((dict(batch), {k: float(v) for k, v in m.items()}, (time.perf_counter() - t_) * 1e3))
        return state, m

    cls.train_step = step
    return seen, lambda: setattr(cls, "train_step", real)


def against_plain_path(pipe, requests, empty_column=None, tie_counts=None):
    """A CTC ``ASRPipeline`` on its fused route: the kernel path vs the plain
    path on the card for every request (same waveforms): logits within 0.05
    of their scale (the tolerance the JAX package holds its Pallas path to),
    greedy ids equal on every frame where the plain path's top-2 margin
    exceeds twice that tolerance. Returns (valid frames, frames whose greedy
    ids agree).

    ``empty_column``: the bank's all-zero filter (reference caveat (k): its
    CMVN column is all NaN or all -1, by the length). The features are then
    held against the plain path's on every other column (2^-6 of their
    scale: two bf16 ulps) and what each side writes in that column is
    printed; an utterance whose plain column is NaN must have no finite
    logit on either side; one whose kernel column alone is non-finite may
    have non-finite kernel logits and is not compared; the others are
    compared as above. ``tie_counts`` (a dict), where given, gains under
    "differ_at_ties" the compared frames whose greedy ids differ where the
    plain path's top-two gap is a tie by the triage rule (within ``TIE`` of
    the logit scale)."""
    import torch

    from huggingface_asr_tpu_torch.models.fast_infer import ctc_infer

    dev, vocab_size = pipe.device, pipe._fused.config.vocab_size
    n_frames = n_agree = 0
    for name, audios in requests.items():
        wav = torch.from_numpy(pipe._bucket_pad(audios)).to(dev)
        lens = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            feats, feat_lens = pipe._frontend(wav, lens)
            feats_p, feat_lens_p = pipe._frontend(wav, lens, plain=True)
            got = ctc_infer(pipe._fused, feats, feat_lens)
            ref = ctc_infer(pipe._fused, feats_p, feat_lens_p, plain=True)
        torch.cuda.synchronize()
        g, r = got.logits.float(), ref.logits.float()
        if g.shape != r.shape or g.shape[:2] != (len(audios), r.shape[1]) \
                or g.shape[-1] != vocab_size + 1:
            _fail(f"{name}: logit shapes {tuple(g.shape)} vs {tuple(r.shape)}")
        if not torch.equal(got.logit_lengths, ref.logit_lengths):
            _fail(f"{name}: logit lengths differ")
        valid = torch.arange(g.shape[1], device=dev)[None, :] < ref.logit_lengths[:, None]
        rows = torch.ones(len(audios), dtype=torch.bool, device=dev)  # the utterances compared
        if empty_column is not None:
            rows = empty_column_rule(name, feats, feats_p, feat_lens, g, r, valid, empty_column)
            valid = valid & rows[:, None]
            if not bool(valid.any()):
                continue
        err = float((g - r).abs()[valid].max())
        scale = float(r.abs()[valid].max())
        tol = 0.05 * max(1.0, scale)
        same = (g.argmax(-1) == r.argmax(-1))[valid]
        top2 = r.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > 2 * tol)[valid]
        n_frames += int(valid.sum())
        n_agree += int(same.sum())
        if tie_counts is not None:
            tie = ((top2[..., 0] - top2[..., 1]) <= TIE * scale)[valid]
            tie_counts["differ_at_ties"] = tie_counts.get("differ_at_ties", 0) + int((~same & tie).sum())
        print(f"{name} logits kernel vs plain: max_abs_err={err:.3e} tol={tol:.3e} "
              f"(scale {scale:.3f}); greedy ids agree on {float(same.float().mean()):.4f} of "
              f"{int(valid.sum())} valid frames, on {int((same & clear).sum())}/{int(clear.sum())} "
              f"frames with a clear margin", flush=True)
        if not bool(torch.isfinite(g[rows]).all()) or err > tol:
            _fail(f"{name}: pipeline logits disagree with the plain path")
        if not bool(same[clear].all()):
            _fail(f"{name}: greedy ids differ on a frame with a clear margin")
    return n_frames, n_agree


def empty_column_rule(name, feats, feats_p, feat_lens, g, r, valid, col):
    """``against_plain_path``'s rule for the all-zero filter's column ``col``
    (reference caveat (k)) on one request: the features (kernel ``feats``,
    plain ``feats_p``) within 2^-6 of their scale on every other column and
    finite there, below each length; the column's values on each side
    printed; an utterance whose plain column is non-finite has no finite
    logit on either side (``g`` kernel, ``r`` plain). Returns the utterances
    whose logits are compared: both columns finite."""
    import torch

    T = feats.shape[1]
    below = torch.arange(T, device=feats.device)[None, :] < feat_lens[:, None]
    keep = [c for c in range(feats.shape[-1]) if c != col]
    fk, fp = feats.float()[..., keep][below], feats_p.float()[..., keep][below]
    f_err, f_scale = float((fk - fp).abs().max()), float(fp.abs().max())
    print(f"{name} features kernel vs plain, every column but {col}: max_abs_err={f_err:.3e} "
          f"tol={2 ** -6 * max(1.0, f_scale):.3e} (scale {f_scale:.3f})", flush=True)
    if not bool(torch.isfinite(fk).all()) or not bool(torch.isfinite(fp).all()) \
            or f_err > 2 ** -6 * max(1.0, f_scale):
        _fail(f"{name}: the features disagree with the plain front end's off column {col}")

    def written(f, i):  # what an utterance's column holds below its length
        v = f[i, :int(feat_lens[i]), col].float()
        return "nan" if bool(torch.isnan(v).all()) else ",".join(f"{x:g}" for x in torch.unique(v).tolist()[:3])

    rows, seen = [], {}
    for i in range(feats.shape[0]):
        k_ok = bool(torch.isfinite(feats[i, :int(feat_lens[i]), col].float()).all())
        p_ok = bool(torch.isfinite(feats_p[i, :int(feat_lens[i]), col].float()).all())
        pair = f"{written(feats, i)}/{written(feats_p, i)}"
        seen[pair] = seen.get(pair, 0) + 1
        if not p_ok:  # the plain side's NaN column: no finite logit on either side
            if bool(torch.isfinite(g[i][valid[i]]).any()) or bool(torch.isfinite(r[i][valid[i]]).any()):
                _fail(f"{name}: utterance {i}, column {col} non-finite on the plain side, yet a finite logit")
        rows.append(k_ok and p_ok)
    print(f"{name} column {col} (kernel/plain) per utterance: {seen}; {sum(rows)} of {len(rows)} utterances "
          f"compared", flush=True)
    return torch.tensor(rows, device=g.device)


def fp32_wide_phase(dev, smi, steps: int = 3, ft_steps: int = 2) -> tuple:
    """The 512-wide config's fp32 training paths (end of step 13): BEST-RQ
    pretraining through ``cli/pretrain.run`` with ``--dtype float32`` and the
    config's own attention_impl ("auto": fp32 K4 at q_rot 512 on the card),
    ``steps`` steps at B=16 x 9.3-10 s and the CLI's evaluation; step 1 again
    with the plain attention; one evaluation batch of the trained weights
    with "pallas" (K5 in fp32); then ``train_ctc.run --from_pretrained`` of its
    ``final/`` in fp32, ``ft_steps`` steps. Returns the launches of the
    pretraining run with the evaluation's, and of the fine-tune, by counter."""
    import torch

    from huggingface_asr_tpu_torch.cli import pretrain as pretrain_cli
    from huggingface_asr_tpu_torch.cli import train_ctc
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train, rel_attention_train_plain
    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
        PretrainingArguments,
    )
    from huggingface_asr_tpu_torch.training.loop import BestRQTrainer, CTCTrainer

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_pretrain_fp32")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(32)
    tok = IdTokenizer()
    letters = list(IdTokenizer.CHARS[1:])
    with open(os.path.join(ROOT, "configs", WIDE_CONFIG)) as f:
        raw = json.load(f)
    wcfg = config_file(WIDE_CONFIG)
    n_l = wcfg.num_hidden_layers
    if wcfg.attention_impl != "auto":
        _fail(f"{WIDE_CONFIG}: attention_impl {wcfg.attention_impl!r}, the phase drives the config's 'auto'")

    def split(n):
        audio = [speech(rng.uniform(9.3, 10.0), rng) for _ in range(n)]
        text = [" ".join("".join(rng.choice(letters, size=rng.integers(3, 8))) for _ in range(rng.integers(8, 14)))
                for _ in range(n)]
        return ColumnTable({"audio": audio, "text": text, "input_len": [len(a) / 16000 for a in audio]})

    def steps_applied(title, seen, n, launches):
        for i, (_, m, ms) in enumerate(seen):
            print(f"  step {i + 1}: loss={m['loss']:.4f} grad_norm={m['grad_norm']:.3f} "
                  f"applied={int(m['step_applied'])} {ms:.1f} ms (host clock, synchronized)", flush=True)
        if len(seen) != n or any(int(m["step_applied"]) != 1 or not np.isfinite(m["loss"]) for _, m, _ in seen):
            _fail(f"{title}: not every one of {n} steps was applied with a finite loss")
        want = {"asr_rel_attention_train_fwd": n * n_l, "asr_rel_attention_train_bwd": n * n_l}
        if any(launches.get(k, 0) != v for k, v in want.items()):
            _fail(f"{title}: launches {launches}, want {want}")

    # ---- BEST-RQ pretraining, fp32, attention_impl "auto"
    print(f"-- fp32 BEST-RQ pretraining (cli/pretrain.run --dtype float32): {WIDE_CONFIG} at full width ({n_l} x "
          f"{wcfg.hidden_size}, q_rot {wcfg.hidden_size}), attention_impl {wcfg.attention_impl!r}, B=16 x 9.3-10 s, "
          f"{steps} steps", flush=True)
    with open(os.path.join(work, "model.json"), "w") as f:
        json.dump(raw, f)
    p_args = ModelArguments(model_config=os.path.join(work, "model.json"), device="cuda", dtype="float32")
    p_training = GeneralTrainingArguments(output_dir=os.path.join(work, "out"), per_device_train_batch_size=16,
                                          per_device_eval_batch_size=16, max_steps=steps, logging_steps=1,
                                          eval_steps=steps, save_steps=10 ** 9, warmup_steps=1, learning_rate=1e-4,
                                          seed=4)
    p_data = {"train": split(16), "validation": split(16)}
    seen, undo = watch_steps(BestRQTrainer)
    torch.cuda.reset_peak_memory_stats()
    try:
        p_out, p_launches = count_launches(
            lambda: pretrain_cli.run(p_args, p_training, PretrainingArguments(), DataConfig(), p_data), {})
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_applied("fp32 BEST-RQ", seen, steps, p_launches)
    with open(os.path.join(work, "out", "metrics.jsonl")) as f:
        p_eval = [json.loads(line) for line in f if "eval/loss" in line]
    print(f"  evaluation loss (the CLI's, 'auto': the plain attention) {p_eval[-1]['eval/loss'] if p_eval else None}; "
          f"peak memory {peak:.2f} GiB; launches over the run {p_launches}; {smi}", flush=True)
    if not p_eval or not np.isfinite(p_eval[-1]["eval/loss"]):
        _fail("fp32 BEST-RQ: no finite evaluation loss")
    final = os.path.join(work, "out", "final")
    if not os.path.exists(os.path.join(final, "pytorch_model.bin")):
        _fail("fp32 BEST-RQ: no final/ written")

    # step 1 again from the same initial weights and batch, with the plain attention
    twin = BestRQTrainer(pretrain_cli.build_model(p_args, p_training.seed), p_out["trainer"].config,
                         frontend=p_out["trainer"].frontend, device="cuda", dtype="float32")
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = twin.train_step(twin.init_state(), seen[0][0])
        if dict(_build.LAUNCHES) != before:
            _fail("the plain-attention fp32 BEST-RQ step launched an attention kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    gaps = {k: abs(seen[0][1][k] - float(m_plain[k])) / abs(float(m_plain[k])) for k in ("loss", "grad_norm")}
    print(f"  fp32 BEST-RQ step 1, kernels vs plain attention: loss {seen[0][1]['loss']:.6f} vs "
          f"{float(m_plain['loss']):.6f} (rel {gaps['loss']:.2e}, tol 1e-4), grad_norm {seen[0][1]['grad_norm']:.5f} "
          f"vs {float(m_plain['grad_norm']):.5f} (rel {gaps['grad_norm']:.2e}, tol 1e-3)", flush=True)
    if gaps["loss"] > 1e-4 or gaps["grad_norm"] > 1e-3:
        _fail("fp32 BEST-RQ step 1 with the attention kernels disagrees with the plain-attention step")
    del twin
    # K4's share of a step's device time: two more steps with the kernels under the profiler
    per_kernel = device_kernel_ms(lambda: p_out["trainer"].train_step(p_out["state"], seen[0][0]), 2)
    k4_ms = sum(v for k, v in per_kernel.items() if "train_fwd_" in k or "train_bwd_" in k)
    print(f"  fp32 BEST-RQ step under the profiler: device {sum(per_kernel.values()):.1f} ms a step, of it K4 "
          f"{k4_ms:.2f} ms ({n_l} forward and {n_l} backward launches)", flush=True)

    # one evaluation batch of the trained weights with "pallas": K5 in fp32 at dh 64
    with open(os.path.join(work, "model_pallas.json"), "w") as f:
        json.dump({**raw, "attention_impl": "pallas"}, f)
    e_args = dataclasses.replace(p_args, model_config=os.path.join(work, "model_pallas.json"))
    evaluator = BestRQTrainer(pretrain_cli.build_model(e_args, p_training.seed), p_out["trainer"].config,
                              frontend=p_out["trainer"].frontend, device="cuda", dtype="float32")
    evaluator.model.load_state_dict(p_out["state"].model.state_dict())
    ev, e_launches = count_launches(lambda: evaluator.eval_step(evaluator.init_state(), seen[0][0]), p_launches)
    print(f"  evaluation batch with 'pallas': loss {float(ev['loss']):.4f}, launches {e_launches}", flush=True)
    if e_launches.get("asr_rel_attention_shift", 0) != n_l or not np.isfinite(float(ev["loss"])):
        _fail(f"fp32 BEST-RQ evaluation with 'pallas': launches {e_launches}, want {n_l} asr_rel_attention_shift")
    # K5's share of an evaluation batch: its host time (synchronized), then its device time under the profiler
    eval_batch = lambda: evaluator.eval_step(evaluator.init_state(), seen[0][0])  # noqa: E731
    host_ms = []
    for _ in range(3):
        t_ = time.perf_counter()
        eval_batch()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t_) * 1e3)
    per_kernel = device_kernel_ms(eval_batch, 2)
    k5_ms = sum(v for k, v in per_kernel.items() if "shift_" in k)
    print(f"  evaluation batch with 'pallas': host {float(np.median(host_ms)):.1f} ms (median of 3, synchronized), "
          f"device {sum(per_kernel.values()):.2f} ms under the profiler, of it K5 {k5_ms:.3f} ms ({n_l} launches); "
          f"{smi}", flush=True)
    del evaluator, p_out, seen
    torch.cuda.empty_cache()

    # ---- CTC fine-tuning of that final/, fp32
    print(f"-- fp32 fine-tuning (train_ctc.run --from_pretrained <fp32 BEST-RQ final/> --dtype float32), vocabulary "
          f"{len(tok)} + blank, B=16 x 9.3-10 s, --no-apply_spec_augment, {ft_steps} steps", flush=True)
    seen, undo = watch_steps(CTCTrainer)
    torch.cuda.reset_peak_memory_stats()
    try:
        _, f_launches = count_launches(lambda: train_ctc.run(
            ModelArguments(from_pretrained=final, device="cuda", dtype="float32"),
            GeneralTrainingArguments(output_dir=os.path.join(work, "ft"), per_device_train_batch_size=16,
                                     max_steps=ft_steps, logging_steps=1, eval_steps=10 ** 9, save_steps=10 ** 9,
                                     warmup_steps=1, learning_rate=1e-4, seed=32, apply_spec_augment=False),
            GenerationArguments(), DataConfig(), {"train": split(16)}, tok), {})
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_applied("fp32 fine-tune", seen, ft_steps, f_launches)
    print(f"  peak memory {peak:.2f} GiB; launches over the run {f_launches}; {smi}", flush=True)
    torch.cuda.empty_cache()
    print(f"fp32 512-wide training paths: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return p_launches, f_launches


# The 256-wide shipped SSL config of the wav2vec2 pretraining run: 12 layers x
# 256, 8 heads of 32, I=1024, conv_dim (256, 256); the quantizer's defaults
# (G=2, V=320, codevector_dim 256, 100 negatives).
SSL_CONFIG = "ebranchformer_30m_ssl.json"
ADAPTERS = "finetune_with_layer_mixing=True;finetune_with_additional_layer=True"


def ssl_phase(dev, smi) -> dict:
    """The rest of SSL on the card (step 15 of the module's docstring):
    wav2vec2 pretraining through ``cli/pretrain.run``, fine-tuning the 512-wide
    phase's BEST-RQ ``final/`` through ``cli/train_ctc.run --from_pretrained``
    with and without the BEST-RQ adapters, serving both fine-tuned models, and
    the refused wav2vec2 graft. Returns the kernel launches of its runs and
    requests, by counter."""
    import logging

    import torch

    from huggingface_asr_tpu_torch.cli import pretrain as pretrain_cli
    from huggingface_asr_tpu_torch.cli import train_ctc
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train, rel_attention_train_plain
    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
        PretrainingArguments,
    )
    from huggingface_asr_tpu_torch.training.loop import CTCTrainer, Wav2Vec2SSLTrainer
    from huggingface_asr_tpu_torch.training.model_factory import load_config, load_state

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_ssl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(15)
    tok = IdTokenizer()
    letters = list(IdTokenizer.CHARS[1:])
    ssl_launches = {}
    counted = functools.partial(count_launches, into=ssl_launches)

    def split(n):
        audio = [speech(rng.uniform(9.3, 10.0), rng) for _ in range(n)]
        text = [" ".join("".join(rng.choice(letters, size=rng.integers(3, 8))) for _ in range(rng.integers(8, 14)))
                for _ in range(n)]
        return ColumnTable({"audio": audio, "text": text, "input_len": [len(a) / 16000 for a in audio]})

    # ---- (a) wav2vec2 pretraining of the 256-wide SSL config through cli/pretrain.run
    scfg = config_file(SSL_CONFIG)
    n_l = scfg.num_hidden_layers
    with open(os.path.join(ROOT, "configs", SSL_CONFIG)) as f:
        w_json = {**json.load(f), "attention_impl": "pallas"}
    with open(os.path.join(work, "w2v.json"), "w") as f:
        json.dump(w_json, f)
    print(f"-- SSL phase (a): wav2vec2 pretraining (cli/pretrain.run), {SSL_CONFIG} ({n_l} x {scfg.hidden_size}, "
          f"{scfg.num_attention_heads} heads), G={scfg.num_codevector_groups} V={scfg.num_codevectors_per_group} "
          f"codevector_dim {scfg.codevector_dim}, {scfg.num_negatives} negatives, mask prob 0.65 length 10, "
          f"B=16 x 9.3-10 s, bf16, attention_impl 'pallas'", flush=True)
    w_data = {"train": split(16), "validation": split(16)}
    w_args = ModelArguments(model_config=os.path.join(work, "w2v.json"), device="cuda", dtype="bfloat16")
    w_training = GeneralTrainingArguments(output_dir=os.path.join(work, "w2v"), per_device_train_batch_size=16,
                                          per_device_eval_batch_size=16, max_steps=3, logging_steps=1, eval_steps=3,
                                          save_steps=10 ** 9, warmup_steps=1, learning_rate=1e-4, seed=15)
    pargs = PretrainingArguments(pretraining_objective="wav2vec2", mask_time_prob=0.65, mask_time_length=10)
    seen, undo = watch_steps(Wav2Vec2SSLTrainer)
    torch.cuda.reset_peak_memory_stats()
    try:
        w_out, w_launches = counted(lambda: pretrain_cli.run(w_args, w_training, pargs, DataConfig(), w_data))
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, (batch, m, ms) in enumerate(seen):
        masked = float(np.mean(np.asarray(batch["mask_time_indices"].cpu())))
        print(f"  step {i + 1}: loss={m['loss']:.4f} contrastive={m['contrastive_loss']:.4f} "
              f"diversity={m['diversity_loss']:.4f} perplexity={m['codevector_perplexity']:.1f} "
              f"gumbel_temperature={m['gumbel_temperature']:.6f} grad_norm={m['grad_norm']:.3f} "
              f"applied={int(m['step_applied'])} masked {100 * masked:.1f} % {ms:.1f} ms", flush=True)
    with open(os.path.join(work, "w2v", "metrics.jsonl")) as f:
        w_eval = [json.loads(line) for line in f if "eval/loss" in line]
    print(f"  evaluation loss {w_eval[-1]['eval/loss'] if w_eval else None}; peak memory {peak:.2f} GiB; launches "
          f"over the run {w_launches}; {smi}", flush=True)
    if len(seen) != 3 or any(int(m["step_applied"]) != 1 or not np.isfinite(m["loss"]) for _, m, _ in seen):
        _fail("wav2vec2: not every one of 3 steps was applied with a finite loss")
    if not w_eval or not np.isfinite(w_eval[-1]["eval/loss"]):
        _fail("wav2vec2: no finite evaluation loss")
    want = {"asr_rel_attention_train_fwd": 3 * n_l, "asr_rel_attention_train_bwd": 3 * n_l,
            "asr_rel_attention_shift": n_l}
    if any(w_launches.get(k, 0) != v for k, v in want.items()):
        _fail(f"wav2vec2 launches {w_launches}, want {want}")
    w_final = os.path.join(work, "w2v", "final")
    if "wav2vec2.masked_spec_embed" not in load_state(w_final):
        _fail("wav2vec2: no final/ with the learned mask embedding written")
    # step 1 again from the same initial weights and Gumbel draw (the step's augment stream), plain attention
    twin = Wav2Vec2SSLTrainer(pretrain_cli.build_model(w_args, w_training.seed, "wav2vec2"), w_out["trainer"].config,
                              frontend=w_out["trainer"].frontend, device="cuda", dtype="bfloat16")
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = twin.train_step(twin.init_state(), seen[0][0])
        if dict(_build.LAUNCHES) != before:
            _fail("the plain-attention wav2vec2 step launched an attention kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    d_loss = abs(seen[0][1]["loss"] - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    print(f"  wav2vec2 step 1, kernels vs plain attention (same Gumbel draw): loss {seen[0][1]['loss']:.6f} vs "
          f"{float(m_plain['loss']):.6f} (rel {d_loss:.2e}, tol 1e-4)", flush=True)
    if d_loss > 1e-4:
        _fail("wav2vec2 step 1 with the attention kernels disagrees with the plain-attention step")
    del twin, w_out, seen
    torch.cuda.empty_cache()

    # ---- (d) a wav2vec2 final/ under a fresh CTC head: refused, as the JAX CLI refuses it (caveat (h))
    try:
        train_ctc.run(ModelArguments(from_pretrained=w_final, device="cuda"),
                      GeneralTrainingArguments(output_dir=os.path.join(work, "w2v_ft"), max_steps=1),
                      GenerationArguments(), DataConfig(), {"train": w_data["train"]}, tok)
        _fail("train_ctc fine-tuned from a wav2vec2 final/: the JAX CLI refuses it")
    except ValueError as e:
        if "masked_spec_embed" not in str(e):
            _fail(f"the wav2vec2 graft's refusal does not name masked_spec_embed: {e}")
        print(f"  (d) train_ctc --from_pretrained <wav2vec2 final/>: refused ({str(e)[:120]}...)", flush=True)

    # ---- (b) fine-tuning the 512-wide BEST-RQ final/ through train_ctc.run, with and without the adapters
    bestrq_final = os.path.join(ROOT, "build", "chip_smoke_pretrain", "out", "final")
    ckpt = load_state(bestrq_final)
    wcfg = load_config(bestrq_final)
    n_w = wcfg.num_hidden_layers
    ft_data = {"train": split(16)}
    finals = {}
    for name, overrides in (("adapters", ADAPTERS), ("no adapters", None)):
        out_dir = os.path.join(work, "ft_" + name.replace(" ", "_"))
        print(f"-- SSL phase (b): train_ctc --from_pretrained <512-wide BEST-RQ final/> ({name}; config overrides "
              f"{overrides}), vocabulary {len(tok)} + blank, B=16 x 9.3-10 s, bf16, --no-apply_spec_augment", flush=True)
        grafted = {}
        real_fit = CTCTrainer.fit

        def fit(self, state, *a, **k):
            grafted.update({k_: v.detach().cpu().clone() for k_, v in state.model.state_dict().items()
                            if k_.startswith("wav2vec2.")})
            return real_fit(self, state, *a, **k)

        seen, undo = watch_steps(CTCTrainer)
        CTCTrainer.fit = fit
        torch.cuda.reset_peak_memory_stats()
        try:
            _, f_launches = counted(lambda: train_ctc.run(
                ModelArguments(from_pretrained=bestrq_final, config_overrides=overrides, device="cuda",
                               dtype="bfloat16"),
                GeneralTrainingArguments(output_dir=out_dir, per_device_train_batch_size=16, max_steps=3,
                                         logging_steps=1, eval_steps=10 ** 9, save_steps=10 ** 9, warmup_steps=1,
                                         learning_rate=1e-4, seed=15, apply_spec_augment=False),
                GenerationArguments(), DataConfig(), ft_data, tok))
        finally:
            undo()
            CTCTrainer.fit = real_fit
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, (_, m, ms) in enumerate(seen):
            print(f"  step {i + 1}: loss={m['loss']:.4f} grad_norm={m['grad_norm']:.3f} "
                  f"applied={int(m['step_applied'])} {ms:.1f} ms", flush=True)
        equal = sorted(grafted) == sorted(k for k in ckpt if k.startswith("wav2vec2.")) and all(
            torch.equal(v, ckpt[k]) for k, v in grafted.items())
        print(f"  encoder at step 0 equal to the checkpoint's, bit for bit: {equal} ({len(grafted)} tensors); "
              f"peak memory {peak:.2f} GiB; launches over the run {f_launches}; {smi}", flush=True)
        if not equal:
            _fail(f"fine-tune ({name}): the encoder at step 0 is not the checkpoint's")
        if len(seen) != 3 or any(int(m["step_applied"]) != 1 or not np.isfinite(m["loss"]) for _, m, _ in seen):
            _fail(f"fine-tune ({name}): not every one of 3 steps was applied with a finite loss")
        want = {"asr_rel_attention_train_fwd": 3 * n_w, "asr_rel_attention_train_bwd": 3 * n_w}
        if any(f_launches.get(k, 0) != v for k, v in want.items()):
            _fail(f"fine-tune ({name}): launches {f_launches}, want {want} (the additional layer takes none)")
        finals[name] = os.path.join(out_dir, "final")

    # ---- (c) serving both fine-tuned final/s through ASRPipeline(device="cuda")
    requests = {f"fine-tuned 512-wide, 8 utts (10 s) #{r}": [speech(10.0 * (1.0 - 0.01 * ((i + r) % 7)), rng)
                                                              for i in range(8)] for r in range(2)}
    pipe = ASRPipeline(finals["no adapters"], model_type="ctc", device="cuda", tokenizer=tok, numeric_profile="exact")
    if not pipe._use_fused:
        _fail("the fine-tuned model without adapters did not take the fused route")
    pipe(requests[next(iter(requests))][:1])  # warm-up
    per_layer = {"asr_layernorm_bf16": 1, "asr_gemm_bf16": 5, "asr_gemm_ln_bf16": 4, "asr_rel_attention": 1,
                 "asr_pos_query": 1, "dwconv_csgu": 1, "dwconv_merge": 1}
    want = {**{k: v * n_w for k, v in per_layer.items()}, "asr_log_mel": 1, "asr_conv1": 0, "asr_conv2": 0}
    for name, audios in requests.items():
        t0 = time.perf_counter()
        texts, got = counted(lambda: pipe(audios))
        print(f"  (c) {name}, fused route: {(time.perf_counter() - t0) * 1e3:.1f} ms; launches {got}", flush=True)
        if len(texts) != len(audios) or any(got.get(k, 0) != v for k, v in want.items()):
            _fail(f"{name}: {len(texts)} transcripts, launches {got}, want {want}")
    frames, agree = against_plain_path(pipe, requests)
    print(f"  (c) fused route vs plain bf16 route: greedy ids agree on {agree}/{frames} valid frames "
          f"({100 * agree / max(frames, 1):.2f} %)", flush=True)
    if agree < 0.98 * frames:
        _fail(f"fine-tuned 512-wide: greedy ids agree on {agree}/{frames} valid frames, below 98 %")
    del pipe

    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    pipeline_log = logging.getLogger("huggingface_asr_tpu_torch.serving.pipeline")
    pipeline_log.addHandler(handler)
    try:
        pipe = ASRPipeline(finals["adapters"], model_type="ctc", device="cuda", tokenizer=tok)
    finally:
        pipeline_log.removeHandler(handler)
    print(f"  (c) adapter model: {logged}", flush=True)
    if pipe._use_fused or not any("finetune_with_layer_mixing" in m for m in logged):
        _fail("the adapter model did not take the plain route with a refusal that names the adapter")
    pipe(requests[next(iter(requests))][:1])  # warm-up
    for name, audios in requests.items():
        t0 = time.perf_counter()
        texts, got = counted(lambda: pipe(audios))
        print(f"  (c) {name}, plain route (adapters): {(time.perf_counter() - t0) * 1e3:.1f} ms; launches {got}",
              flush=True)
        if len(texts) != len(audios) or got.get("asr_rel_attention_shift", 0) != n_w or \
                any(got.get(k, 0) for k in per_layer):
            _fail(f"{name} (adapters): {len(texts)} transcripts, launches {got}, want {n_w} K5 and no K1")
    del pipe
    torch.cuda.empty_cache()
    print(f"SSL phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ssl_launches


def cli_phase(dev, smi) -> dict:
    """The CTC command-line surface on the card (step 12 of the module's
    docstring), through ``train_ctc.run`` and ``evaluate.run`` with in-memory
    corpus rows and stand-in tokenizers. Returns the kernel launches of its
    runs, by counter."""
    import torch

    from huggingface_asr_tpu_torch.cli import evaluate, train_ctc
    from huggingface_asr_tpu_torch.cli.common import eval_batches
    from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig
    from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows
    from huggingface_asr_tpu_torch.decoding.generate import generate_joint
    from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )
    from huggingface_asr_tpu_torch.training.model_factory import load_aed_model, load_ctc_model, save_params
    from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    os.makedirs(work, exist_ok=True)
    cli_launches = {}
    counted = functools.partial(count_launches, into=cli_launches)

    # ---- train_ctc at the flagship width, from the Flax-matching initialiser
    tok = IdTokenizer()
    cfg = flagship_config(vocab_size=len(tok), attention_impl="pallas")
    with open(os.path.join(work, "model.json"), "w") as f:
        f.write(cfg.to_json())
    rows = corpus_rows(n_train=128, n_eval=32, seed=1)
    dataset = {split: ColumnTable(r) for split, r in rows.items()}
    audio_s = float(sum(rows["test"]["input_len"]))
    print(f"-- CLI phase: train_ctc (flagship {cfg.num_hidden_layers} x {cfg.hidden_size}, vocabulary "
          f"{len(tok)} + blank, attention_impl 'pallas': K4 in the train step, K5 in evaluation), B=16 of "
          f"{min(rows['train']['input_len']):.1f}-{max(rows['train']['input_len']):.1f} s synthetic speech",
          flush=True)

    def train(name, steps, *flags):
        out = os.path.join(work, name)
        argv = ["--model_config", os.path.join(work, "model.json"), "--output_dir", out,
                "--per_device_train_batch_size", "16", "--per_device_eval_batch_size", "16",
                "--max_steps", str(steps), "--logging_steps", "1", "--eval_steps", "4", "--save_steps", "1000",
                "--warmup_steps", "2", "--learning_rate", "5e-4", "--pad_to_multiple", "100", *flags]
        groups = [ModelArguments, GeneralTrainingArguments, GenerationArguments, DataConfig]
        args = DataclassArgumentParser(groups).parse_args_into_dataclasses(argv)
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        results, launches = counted(lambda: train_ctc.run(*args, dataset, tok))
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        steps_ = [r for r in logged if "loss" in r]
        evals = [r for r in logged if "eval/wer" in r]
        times = [r["time"] for r in logged]
        # host-clock step times: gaps between consecutive step records, less those that hold an evaluation
        gaps = [1e3 * (b["time"] - a["time"]) for a, b in zip(steps_, steps_[1:])
                if not any(a["time"] < e["time"] <= b["time"] for e in evals)]
        applied = sum(int(r["step_applied"]) for r in steps_)
        print(f"  train_ctc {name}: {len(steps_)} steps in {wall:.1f} s ({max(times) - min(times):.1f} s from "
              f"the first to the last record), applied {applied}, rejected {len(steps_) - applied}; "
              f"step ms (host clock, no evaluation in the gap): median {float(np.median(gaps)):.1f} of "
              f"{[round(g, 1) for g in gaps]}; launches {launches}", flush=True)
        for r in steps_:
            print(f"    step {r['step']}: loss={r['loss']:.4f} grad_norm={r['grad_norm']:.3f} "
                  f"applied={int(r['step_applied'])}", flush=True)
        for r in evals:
            print(f"    eval @{r['step']}: loss={r['eval/loss']:.4f} wer={r['eval/wer']:.4f}", flush=True)
        if len(steps_) != steps or not all(np.isfinite(r["loss"]) for r in steps_):
            _fail(f"train_ctc {name}: {len(steps_)} of {steps} steps logged, or a loss is not finite")
        for k in ("asr_rel_attention_train_fwd", "asr_rel_attention_train_bwd"):
            if launches.get(k, 0) != steps * cfg.num_hidden_layers:
                _fail(f"train_ctc {name}: {launches.get(k, 0)} launches of {k}, want {steps * cfg.num_hidden_layers}")
        if launches.get("asr_rel_attention_shift", 0) <= 0 or not evals:
            _fail(f"train_ctc {name}: the evaluation step did not launch K5")
        if "test" not in results or not os.path.exists(os.path.join(out, "final", "pytorch_model.bin")):
            _fail(f"train_ctc {name}: no final/ or no test-split evaluation")
        return out, steps_, gaps

    train("defaults", 8)  # the JAX defaults: SpecAugment on (caveat (b) may reject steps)
    out, steps_, gaps = train("no_spec_augment", 4, "--no-apply_spec_augment")
    if not all(int(r["step_applied"]) == 1 for r in steps_):
        _fail("train_ctc --no-apply_spec_augment: a step was rejected")
    final = os.path.join(out, "final")

    # ---- evaluate --model_type ctc on that final/: the kernel route and the plain bf16 model
    def evaluate_ctc(model_dir, route, table, tokenizer, batch_size, dtype="bfloat16", name=""):
        out_dir = os.path.join(work, f"eval_{name}_{route}")
        args = (evaluate.EvalArguments(output_dir=out_dir, batch_size=batch_size, model_type="ctc",
                                       fused_encoder=route),
                ModelArguments(from_pretrained=model_dir, dtype=dtype), GenerationArguments(), DataConfig())
        evaluate.run(*args, {"test": table}, tokenizer)  # warm-up: folds, tables, the allocator
        results, launches = counted(lambda: evaluate.run(*args, {"test": table}, tokenizer))
        return results["test"], launches, out_dir

    test = ColumnTable(rows["test"])
    walls = {}
    for route in ("on", "off"):
        res, launches, out_dir = evaluate_ctc(final, route, test, tok, 16, name="flagship")
        walls[route] = res.wall_time
        print(f"  evaluate --model_type ctc --fused_encoder {route}: {res.num_examples} utterances "
              f"({audio_s:.1f} s of audio) at batch 16 in {1e3 * res.wall_time:.1f} ms, RTFx "
              f"{audio_s / res.wall_time:.0f}; WER {res.metrics['wer']:.3f}; launches {launches}; {smi}", flush=True)
        if route == "on":
            want = ("asr_log_mel", "asr_cmvn", "asr_conv1", "asr_conv2", "asr_gemm_bf16", "asr_gemm_ln_bf16",
                    "asr_layernorm_bf16", "asr_pos_query", "asr_rel_attention", "dwconv_csgu", "dwconv_merge")
            missing = [k for k in want if launches.get(k, 0) <= 0]
            if missing or launches.get("asr_rel_attention", 0) != cfg.num_hidden_layers * 2:
                _fail(f"evaluate --fused_encoder on: not launched {missing}; launches {launches}")
        elif set(launches) - {"asr_rel_attention_shift"}:
            # the plain model runs K5 for its attention core where the config
            # says "pallas", and nothing else
            _fail(f"evaluate --fused_encoder off launched the kernel route's kernels: {launches}")
        for suffix in (".csv", "_hyp.trn", "_ref.trn"):
            if not os.path.exists(os.path.join(out_dir, f"predictions_test{suffix}")):
                _fail(f"evaluate --fused_encoder {route} wrote no predictions_test{suffix}")
    ids = {r: _csv_ids(os.path.join(work, f"eval_flagship_{r}", "predictions_test.csv")) for r in ("on", "off")}
    print(f"  the two routes' transcripts: {sum(a == b for a, b in zip(ids['on'], ids['off']))}/{len(ids['on'])} "
          f"equal", flush=True)

    # the two routes' logits on the CLI's batches, held as the serving phase holds them
    model = load_ctc_model(final, dev)
    routes = {r: evaluate.CTCRoute(model, r, dev, torch.bfloat16) for r in ("on", "off")}
    collator = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(batch_size=16, pad_to_multiple=16000)))
    n_frames = n_agree = 0
    for batch in eval_batches(test, collator, 16):
        wav = torch.from_numpy(batch["input_values"]).to(dev)
        lens = torch.from_numpy(batch["input_values_lengths"]).to(dev)
        got, ref = routes["on"](wav, lens), routes["off"](wav, lens)
        if not torch.equal(got.logit_lengths, ref.logit_lengths):
            _fail("evaluate: the two CTC routes' lengths differ")
        g, r = got.logits.float(), ref.logits.float()
        valid = torch.arange(g.shape[1], device=dev)[None, :] < ref.logit_lengths[:, None]
        err, scale = float((g - r).abs()[valid].max()), float(r.abs()[valid].max())
        tol = 0.05 * max(1.0, scale)
        same = (g.argmax(-1) == r.argmax(-1))[valid]
        top2 = r.topk(2, dim=-1).values
        clear = ((top2[..., 0] - top2[..., 1]) > 2 * tol)[valid]
        n_frames, n_agree = n_frames + int(valid.sum()), n_agree + int(same.sum())
        print(f"  evaluate routes, kernel vs plain bf16 model: max_abs_err={err:.3e} tol={tol:.3e} (scale "
              f"{scale:.3f}); ids agree on {int(same.sum())}/{int(valid.sum())} frames, on "
              f"{int((same & clear).sum())}/{int(clear.sum())} with a clear margin", flush=True)
        if not bool(torch.isfinite(g).all()) or err > tol or not bool(same[clear].all()):
            _fail("evaluate: the kernel route disagrees with the plain bf16 model")
    if n_agree < 0.98 * n_frames:
        _fail(f"evaluate: greedy ids agree on {n_agree}/{n_frames} frames, below 98 %")

    # ---- the committed gate model: both routes against the JAX evaluate CLI's ids
    with open(os.path.join(ROOT, GATE_DIR, "jax_reference.json")) as f:
        ref = json.load(f)
    gate_rows = corpus_rows(n_train=512, n_eval=64, seed=0)["test"]
    gate_table, blank = ColumnTable(gate_rows), ref["blank_id"]
    gate_tok = IdTokenizer(blank)
    gate_model = load_ctc_model(os.path.join(ROOT, GATE_DIR), dev)
    gate_count = {}
    for route, dtype, key in (("on", "bfloat16", "bfloat16"), ("off", "bfloat16", "bfloat16"),
                              ("off", "float32", "float32")):
        res, launches, out_dir = evaluate_ctc(os.path.join(ROOT, GATE_DIR), route, gate_table, gate_tok, 32,
                                              dtype, name=f"gate_{dtype}")
        got = _csv_ids(os.path.join(out_dir, "predictions_test.csv"))
        want = ref[key]["ids"]
        differ = [u for u in range(len(want)) if got[u] != want[u]]
        gate_count[f"{route} {dtype}"] = len(want) - len(differ)
        gaps = []
        if differ and dtype == "bfloat16":
            # the triage rule at the first frame where this route's argmax leaves JAX's (bf16 frame ids)
            gate_route = evaluate.CTCRoute(gate_model, route, dev, getattr(torch, dtype))
            for start, batch in zip(range(0, len(want), 32), eval_batches(gate_table, SpeechCollator(
                    CollatorConfig(bucketing=BucketingConfig(batch_size=32, pad_to_multiple=16000))), 32)):
                out = gate_route(torch.from_numpy(batch["input_values"]).to(dev),
                                 torch.from_numpy(batch["input_values_lengths"]).to(dev))
                logits = out.logits.float().cpu().numpy()
                for u in [u for u in differ if start <= u < start + 32]:
                    T = int(out.logit_lengths[u - start])
                    frames = logits[u - start, :T].argmax(-1)
                    jf = np.asarray(ref["bfloat16"]["frame_ids"][u])
                    t = int(np.flatnonzero(frames != jf)[0]) if len(jf) == T and (frames != jf).any() else 0
                    top2 = np.sort(logits[u - start, t])[-2:]
                    gaps.append((u, t, float(top2[1] - top2[0]), float(np.abs(logits[u - start, :T]).max())))
        print(f"  gate model, evaluate --fused_encoder {route} at {dtype}: {len(want) - len(differ)}/{len(want)} "
              f"id sequences equal to the JAX evaluate CLI's; {res.num_examples} utterances in "
              f"{1e3 * res.wall_time:.1f} ms; launches {launches}" + "".join(
                  f"; utterance {u} frame {t}: top-two gap {g:.5f} of scale {s:.3f} (bound {TIE * s:.5f})"
                  for u, t, g, s in gaps), flush=True)
        if route == "on":
            if any(launches.get(k, 0) <= 0 for k in ("asr_log_mel", "asr_cmvn", "asr_rel_attention")):
                _fail(f"gate model: the kernel route did not launch the log-mel and layer kernels: {launches}")
            for u, t, g, s in gaps:
                if g > TIE * s:
                    _fail(f"gate model: utterance {u} differs from JAX at frame {t} beyond a tie")
    print(f"gate: {gate_count['on bfloat16']}/64 equal to JAX", flush=True)

    # ---- evaluate --model_type aed with --save_nbest against generate_joint called directly
    aed_dir = os.path.join(work, "aed")
    save_params(aed_model(seed=3), aed_dir)
    aed_tok = IdTokenizer(AED_VOCAB, specials=(0, 1, 2, 3))
    aed_rows = {k: v[:8] for k, v in rows["test"].items()}
    aed_out = os.path.join(work, "eval_aed")
    gen = GenerationArguments(num_beams=5, ctc_weight=0.3, max_length=32, save_nbest=True)
    args = (evaluate.EvalArguments(output_dir=aed_out, batch_size=8, model_type="aed"),
            ModelArguments(from_pretrained=aed_dir), gen, DataConfig())
    t0 = time.perf_counter()
    res, launches = counted(lambda: evaluate.run(*args, {"test": ColumnTable(aed_rows)}, aed_tok))
    wall = time.perf_counter() - t0
    print(f"  evaluate --model_type aed (configs/{AED_CONFIG}, 5 beams, ctc_weight 0.3, max_length 32, "
          f"--save_nbest): 8 utterances in {1e3 * res['test'].wall_time:.1f} ms ({wall:.1f} s with the model's "
          f"load); launches {launches}", flush=True)
    names = ("nbest_hyps.txt", "nbest_scores.txt", "nbest_att_scores.txt", "nbest_ctc_scores.txt",
             "nbest_lm_scores.txt")
    if any(not os.path.exists(os.path.join(aed_out, n)) for n in names):
        _fail(f"evaluate --model_type aed wrote no {names}")
    if any(launches.get(k, 0) <= 0 for k in ("asr_conv1", "asr_conv2", "asr_rel_attention")):
        _fail(f"evaluate --model_type aed did not take the kernel route: {launches}")
    model = load_aed_model(aed_dir, dev, torch.bfloat16)
    batch = next(iter(eval_batches(ColumnTable(aed_rows), SpeechCollator(
        CollatorConfig(bucketing=BucketingConfig(batch_size=8, pad_to_multiple=16000))), 8)))
    feats, lens = LogMelFrontEnd(LogMelConfig(num_mel_bins=model.config.encoder.num_fbanks))(
        torch.from_numpy(batch["input_values"]).to(dev), torch.from_numpy(batch["input_values_lengths"]).to(dev))
    gen_cfg = dataclasses.replace(evaluate.build_generation_config(gen, {"bos": 0, "eos": 1, "pad": 3}),
                                  return_components=True)
    with torch.inference_mode():
        seqs, scores, _ = generate_joint(model, feats, lens, gen_cfg, fused=FusedCTC(model.encoder, dev))
    with open(os.path.join(aed_out, "nbest_hyps.txt")) as f:
        hyps = [line.rstrip("\n").split(" ", 1) for line in f]
    with open(os.path.join(aed_out, "nbest_scores.txt")) as f:
        cli_scores = [float(line.split()[1]) for line in f]
    direct = [aed_tok.decode([int(t) for t in row[0]]) for row in seqs.cpu().numpy()]
    best = [h[1] if len(h) > 1 else "" for h in hyps[::gen_cfg.num_beams]]
    d_scores = scores[:, 0].float().cpu().numpy()
    s_err = float(np.abs(np.asarray(cli_scores[::gen_cfg.num_beams]) - d_scores).max())
    print(f"  evaluate --model_type aed vs generate_joint called directly: best hypotheses equal in "
          f"{sum(a == b for a, b in zip(best, direct))}/8, scores within {s_err:.2e}", flush=True)
    if best != direct or s_err > 1e-5 * max(1.0, float(np.abs(d_scores).max())):
        _fail("evaluate --model_type aed: the best hypotheses differ from generate_joint's")
    print(f"  CLI phase launches (train, evaluate, gate, aed): {cli_launches}", flush=True)
    return cli_launches


# The recipe families' published widths: whisper-small.en (vocabulary 51,864) and GPT-2 small's LLM
WHISPER_SMALL = dict(num_mel_bins=80, d_model=768, encoder_layers=12, encoder_attention_heads=12,
                     encoder_ffn_dim=3072, max_source_positions=1500)
WHISPER_VOCAB, GPT2_VOCAB = 51864, 50257
GPT2_SMALL = dict(n_embd=768, n_layer=12, n_head=12, n_positions=1024, add_cross_attention=False)


def reference_init_(model, seed: int):
    """Seeded weights drawn as HF initialises Whisper and GPT-2 (``init_std``
    0.02): every matrix (and the frozen vocabulary kernel) ~ N(0, 0.02^2),
    LayerNorm scales 1, every other vector 0. From the Flax defaults' draws
    (``init_whisper_from_scratch_``, what the CLIs draw when nothing is
    loaded) a whisper-small-wide Whisper-CTC step's gradient norm reads ~600
    on an H100 (``PERF.md``), past the trainers' guard of 100, which the JAX
    trainer applies too."""
    import torch

    from huggingface_asr_tpu_torch.models.ebranchformer import init_random_

    generator = torch.Generator().manual_seed(seed)
    init_random_(model, generator, matrix_std=0.02)
    ln = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0 if name in ln else 0.0)
        for name, b in model.named_buffers():
            if name.endswith("lm_head_frozen_kernel"):
                b.copy_(0.02 * torch.randn(b.shape, generator=generator))
    return model


def recipe_phase(dev, smi) -> dict:
    """The recipe families on the card (step 16 of the module's docstring),
    through ``train_ctc.run``, ``train_aed.run``, ``evaluate.run`` and
    ``generate_whisper`` with in-memory corpus rows and stand-in tokenizers.
    Returns the kernel launches of its decode routes, by counter."""
    import torch

    from huggingface_asr_tpu_torch.cli import evaluate, train_aed, train_ctc
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
    from huggingface_asr_tpu_torch.decoding.generate import generate_whisper
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )
    from huggingface_asr_tpu_torch.training.loop import CTCTrainer, LLMASRTrainer, Seq2SeqTrainer
    from huggingface_asr_tpu_torch.models.llm_asr import LLMASRConfig, LLMASRModel
    from huggingface_asr_tpu_torch.models.whisper_ctc import WhisperCTCConfig, WhisperEncoderForCTC
    from huggingface_asr_tpu_torch.models.whisper_seq2seq import WhisperForConditionalGeneration, WhisperSeq2SeqConfig
    from huggingface_asr_tpu_torch.training.model_factory import (
        load_llm_asr_model,
        load_state,
        load_whisper_ctc_model,
        load_whisper_model,
        save_params,
    )

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_recipes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(16)
    recipe_launches = {}
    bf16 = torch.bfloat16

    def split(n, vocab, seconds=None):
        # label rows of 100-150 ids: the stand-in's character rate for 10 s of speech
        audio = [speech(seconds or rng.uniform(9.3, 10.0), rng) for _ in range(n)]
        labels = [rng.integers(4, vocab, rng.integers(100, 151)).tolist() for _ in range(n)]
        return ColumnTable({"audio": audio, "labels": labels, "text": [" ".join(map(str, x)) for x in labels],
                            "input_len": [len(a) / 16000 for a in audio]})

    def batch_of(table):
        waves = table["audio"]
        wav = torch.zeros(len(waves), max(len(w) for w in waves), device=dev)
        for i, w in enumerate(waves):
            wav[i, :len(w)] = torch.from_numpy(w)
        return wav, torch.tensor([len(w) for w in waves], dtype=torch.int32, device=dev)

    def seeded(name, model):
        """A model directory of ``model`` under ``reference_init_``'s seeded weights."""
        path = os.path.join(work, name)
        save_params(reference_init_(model, 16), path)
        return path

    def trained(trainer_cls, run, n_steps, what):
        """Run ``run()`` with ``trainer_cls.train_step`` watched: (result, steps), each step
        (metrics, host ms, peak GiB); fails unless every step was applied with a finite loss."""
        seen, restore = watch_steps(trainer_cls)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = run()
        finally:
            restore()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, (_, m, ms) in enumerate(seen):
            extra = f" enc_loss={m['enc_loss']:.4f}" if "enc_loss" in m else ""
            print(f"  {what} step {i + 1}: loss={m['loss']:.4f}{extra} grad_norm={m['grad_norm']:.3f} "
                  f"applied={int(m['step_applied'])} {ms:.1f} ms (host clock, synchronized)", flush=True)
        print(f"  {what}: {len(seen)} steps, the run (steps, final/, the test split's decode) {wall:.1f} s, peak "
              f"memory {peak:.2f} GiB; {smi}", flush=True)
        if len(seen) != n_steps or not all(int(m["step_applied"]) == 1 and np.isfinite(m["loss"]) for _, m, _ in seen):
            _fail(f"{what}: not every one of {n_steps} steps was applied with a finite loss")
        return out

    def timed_ms(fn, reps=3):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times))

    def training_args(out, batch, steps):
        return GeneralTrainingArguments(output_dir=out, per_device_train_batch_size=batch,
                                        per_device_eval_batch_size=8, max_steps=steps, logging_steps=1,
                                        eval_steps=10 ** 9, save_steps=10 ** 9, warmup_steps=1,
                                        learning_rate=1e-4, seed=3, apply_spec_augment=False)

    def k3_per_batch(launches, what):
        if launches != {"asr_log_mel": 1, "asr_cmvn": 1}:
            _fail(f"{what}: launches {launches}, want one mel and one cmvn launch for the batch")

    # ---- (a) Whisper-encoder CTC
    tok = IdTokenizer(WHISPER_VOCAB, specials=(0, 1, 2, 3))
    W = WHISPER_SMALL
    ctc_cfg = {**W, "llm_dim": W["d_model"], "additional_head_count": W["encoder_attention_heads"],
               "blank_token_id": 0, "vocab_size": WHISPER_VOCAB}
    test = split(8, WHISPER_VOCAB, seconds=10.0)
    data = {"train": split(48, WHISPER_VOCAB), "test": test}
    print(f"-- recipe phase (a): Whisper-encoder CTC at whisper-small.en widths (12 x 768, 12 heads, FFN 3072, "
          f"80 mel bins; llm_dim 768, additional layer of 12 heads; vocabulary {WHISPER_VOCAB}, blank 0), "
          f"train_ctc.run --from_pretrained of seeded weights (reference_init_), B=16 x 9.3-10 s, label rows of "
          f"100-150 ids, bf16 over fp32 weights, no SpecAugment", flush=True)
    out_a = os.path.join(work, "whisper_ctc")
    model_args = ModelArguments(model_family="whisper_ctc", device="cuda", dtype="bfloat16",
                                from_pretrained=seeded("whisper_ctc_init", WhisperEncoderForCTC(
                                    WhisperCTCConfig(**ctc_cfg))))
    trained(CTCTrainer, lambda: train_ctc.run(model_args, training_args(out_a, 16, 3), GenerationArguments(),
                                              DataConfig(), data, tok), 3, "train_ctc whisper_ctc")
    final_a = os.path.join(out_a, "final")
    for route in ("on", "off"):
        eval_args = evaluate.EvalArguments(output_dir=os.path.join(work, f"eval_whisper_ctc_{route}"), batch_size=8,
                                           model_type="whisper_ctc", fused_encoder=route)
        (res, wall), got = count_launches(lambda: timed_ms(lambda: evaluate.run(
            eval_args, ModelArguments(from_pretrained=final_a, device="cuda", dtype="bfloat16"),
            GenerationArguments(), DataConfig(), {"test": test}, tok), reps=1), recipe_launches)
        print(f"  evaluate whisper_ctc --fused_encoder {route}: 8 x 10 s in {wall:.1f} ms (model load "
              f"included), wer {res['test'].metrics['wer']:.4f}, launches {got}", flush=True)
        if route == "on":
            k3_per_batch(got, "evaluate whisper_ctc on")
        elif got:
            _fail(f"evaluate whisper_ctc off launched kernels: {got}")
    model = load_whisper_ctc_model(final_a, "cuda", bf16)
    wav, lens = batch_of(test)
    fused_route = evaluate.WhisperCTCRoute(model, "on", dev, bf16)
    plain_route = evaluate.WhisperCTCRoute(model, "off", dev, bf16)
    out_k, got = count_launches(lambda: fused_route(wav, lens), recipe_launches)
    k3_per_batch(got, "the Whisper-CTC kernel route")
    out_p = plain_route(wav, lens)
    _, ms_k = timed_ms(lambda: fused_route(wav, lens))
    _, ms_p = timed_ms(lambda: plain_route(wav, lens))
    err = float((out_k.logits.float() - out_p.logits.float()).abs().max())
    scale = max(1.0, float(out_p.logits.float().abs().max()))
    valid = torch.arange(out_k.logits.shape[1], device=dev)[None, :] < out_k.logit_lengths[:, None]
    agree = float((out_k.logits.argmax(-1) == out_p.logits.argmax(-1))[valid].float().mean())
    print(f"  Whisper-CTC decode B=8 x 10 s: kernel route {ms_k:.2f} ms, plain route {ms_p:.2f} ms (median of 3, "
          f"host clock); logits max |diff| {err:.4f} of scale {scale:.2f} (tol 0.05 x scale), greedy ids equal on "
          f"{100 * agree:.2f} % of valid frames (bar 98 %)", flush=True)
    if not torch.equal(out_k.logit_lengths, out_p.logit_lengths) or err > 0.05 * scale or agree < 0.98:
        _fail("the Whisper-CTC kernel route disagrees with the plain route")
    del model, fused_route, plain_route, out_k, out_p
    # the LearnableBlankLinear head: its frozen vocabulary kernel through two steps
    out_b = os.path.join(work, "whisper_ctc_blank")
    blank_init = seeded("whisper_ctc_blank_init", WhisperEncoderForCTC(
        WhisperCTCConfig(**ctc_cfg, learnable_blank_head=True)))
    blank_args = dataclasses.replace(model_args, from_pretrained=blank_init)
    trained(CTCTrainer, lambda: train_ctc.run(blank_args, training_args(out_b, 16, 2), GenerationArguments(),
                                              DataConfig(), {"train": data["train"]}, tok), 2,
            "train_ctc whisper_ctc learnable_blank_head")
    init, saved = load_state(blank_init), load_state(os.path.join(out_b, "final"))
    frozen_equal = torch.equal(saved["lm_head_frozen_kernel"], init["lm_head_frozen_kernel"])
    blank_moved = not torch.equal(saved["blank_kernel"], init["blank_kernel"])
    print(f"  learnable_blank_head: frozen vocabulary kernel bit-equal after 2 steps {frozen_equal}, blank "
          f"column moved {blank_moved}", flush=True)
    if not (frozen_equal and blank_moved):
        _fail("learnable_blank_head: the frozen kernel moved or the blank column did not")
    del init, saved
    torch.cuda.empty_cache()

    # ---- (b) Whisper seq2seq
    s2s_cfg = {**W, "decoder_layers": W["encoder_layers"], "decoder_attention_heads": W["encoder_attention_heads"],
               "decoder_ffn_dim": W["encoder_ffn_dim"], "max_target_positions": 448, "vocab_size": WHISPER_VOCAB,
               "decoder_start_token_id": 0, "eos_token_id": 1, "pad_token_id": 3}
    print(f"-- recipe phase (b): Whisper seq2seq at whisper-small.en widths (12 + 12 layers x 768, 448 target "
          f"positions, vocabulary {WHISPER_VOCAB}), train_aed.run --model_family whisper B=16 x 9.3-10 s, bf16 "
          f"over fp32 weights, from seeded weights (reference_init_)", flush=True)
    out_s = os.path.join(work, "whisper")
    forced = ((1, WHISPER_VOCAB - 4), (2, WHISPER_VOCAB - 3))
    s2s_args = ModelArguments(model_family="whisper", device="cuda", dtype="bfloat16", from_pretrained=seeded(
        "whisper_init", WhisperForConditionalGeneration(WhisperSeq2SeqConfig(**s2s_cfg))))
    gen = GenerationArguments(num_beams=5, max_length=32)
    trained(Seq2SeqTrainer, lambda: train_aed.run(s2s_args, training_args(out_s, 16, 3), gen, DataConfig(), data,
                                                  tok, forced_decoder_ids=forced), 3, "train_aed whisper")
    model = load_whisper_model(os.path.join(out_s, "final"), "cuda", bf16)
    frontend = LogMelFrontEnd(LogMelConfig())
    feats, feat_lens = frontend(*batch_of(test))
    suppress = tuple(range(WHISPER_VOCAB // 2, WHISPER_VOCAB // 2 + min(200, WHISPER_VOCAB // 4)))
    beam = BeamSearchConfig(num_beams=5, max_length=32, ctc_weight=0.0, num_candidates=64, bos_token_id=0,
                            eos_token_id=1, pad_token_id=3)
    n_steps = []

    def decode():
        n_steps.clear()
        with torch.inference_mode():
            return generate_whisper(model, feats, feat_lens, beam, forced_decoder_ids=forced, suppress_tokens=suppress,
                                    hook=lambda name, alive=None: n_steps.append(1) if name == "decoder" else None)

    (seqs, scores), ms = timed_ms(decode)
    seqs = seqs.cpu().numpy()
    ok = not np.isin(seqs, suppress).any() and all((seqs[:, :, p] == t).all() for p, t in forced)
    print(f"  generate_whisper B=8 x 10 s, 5 beams, max_length 32, 2 forced ids, {len(suppress)} suppressed: "
          f"{ms:.1f} ms (median of 3, host clock) for {len(n_steps)} decode steps, {ms / max(len(n_steps), 1):.2f} "
          f"ms a step; scores finite {bool(torch.isfinite(scores).all())}; no suppressed token and every forced "
          f"position held: {ok}; {smi}", flush=True)
    if not ok or not bool(torch.isfinite(scores).all()):
        _fail("generate_whisper: a suppressed token or a missing forced id, or a non-finite score")
    del model, feats
    torch.cuda.empty_cache()

    # ---- (c) LLM-ASR
    tok = IdTokenizer(GPT2_VOCAB, specials=(0, 1, 2, 3))
    llm_cfg = {"encoder": {**ctc_cfg, "vocab_size": GPT2_VOCAB}, "number_of_prompt_tokens": 16, "ctc_weight": 0.3,
               "decoder": {**GPT2_SMALL, "vocab_size": GPT2_VOCAB, "bos_token_id": 0, "eos_token_id": 1,
                           "pad_token_id": 3}}
    test = split(8, GPT2_VOCAB, seconds=10.0)
    print(f"-- recipe phase (c): LLM-ASR (the Whisper-CTC encoder above; GPT-2 small: 12 x 768, 12 heads, 1024 "
          f"positions, vocabulary {GPT2_VOCAB}; 16 soft prompts, ctc_weight 0.3), train_ctc.run B=8 x 9.3-10 s "
          f"from seeded weights (reference_init_), label rows of 100-150 ids (plan 1 + 16 + 500 + 1 + L <= 1024), "
          f"bf16 over fp32 weights", flush=True)
    out_l = os.path.join(work, "llm_asr")
    llm_args = ModelArguments(model_family="llm_asr", device="cuda", dtype="bfloat16", from_pretrained=seeded(
        "llm_asr_init", LLMASRModel(LLMASRConfig.from_dict(llm_cfg))))
    trained(LLMASRTrainer, lambda: train_ctc.run(llm_args, training_args(out_l, 8, 2), GenerationArguments(),
                                                 DataConfig(), {"train": split(16, GPT2_VOCAB)}, tok), 2,
            "train_ctc llm_asr")
    final_l = os.path.join(out_l, "final")
    for route in ("on", "off"):
        eval_args = evaluate.EvalArguments(output_dir=os.path.join(work, f"eval_llm_asr_{route}"), batch_size=8,
                                           model_type="llm_asr", fused_encoder=route)
        (res, wall), got = count_launches(lambda: timed_ms(lambda: evaluate.run(
            eval_args, ModelArguments(from_pretrained=final_l, device="cuda", dtype="bfloat16"),
            GenerationArguments(max_length=16), DataConfig(), {"test": test}, tok), reps=1), recipe_launches)
        print(f"  evaluate llm_asr --fused_encoder {route}: 8 x 10 s, 16 greedy tokens (16 whole-model passes) in "
              f"{wall:.1f} ms (model load included), launches {got}", flush=True)
        if route == "on":
            k3_per_batch(got, "evaluate llm_asr on")
        elif got:
            _fail(f"evaluate llm_asr off launched kernels: {got}")
    model = load_llm_asr_model(final_l, "cuda", bf16)
    wav, lens = batch_of(test)
    fused_route = evaluate.LLMASRRoute(model, "on", dev, 16)
    plain_route = evaluate.LLMASRRoute(model, "off", dev, 16)
    (toks_k, _), ms_k = timed_ms(lambda: fused_route(wav, lens))
    (toks_p, _), ms_p = timed_ms(lambda: plain_route(wav, lens))
    P = model.config.number_of_prompt_tokens
    labels = torch.full((8, 16), 3, dtype=torch.int64, device=dev)
    label_lengths = torch.full((8,), 16, dtype=torch.int32, device=dev)
    rows = torch.arange(8, device=dev)
    real_encoder = model.encoder.forward
    with torch.inference_mode():
        (f_k, l_k), (f_p, l_p) = fused_route.frontend(wav, lens), plain_route.frontend(wav, lens)
        own = [model(f, fl, labels=labels, label_lengths=label_lengths).asr_lengths
               for f, fl in ((f_k, l_k), (f_p, l_p))]
        enc_k, enc_p = model.encoder(f_k.to(bf16), l_k), model.encoder(f_p.to(bf16), l_p)
        # one CTC plan for both routes, every valid frame kept (ids 4, 5, 4, ...:
        # no blank, no repeat), so that the LLM's first-step logits differ only
        # through the frames each front end feeds it
        T = enc_p.logits.shape[1]
        plan = torch.zeros_like(enc_p.logits)
        plan[:, torch.arange(T, device=dev), 4 + torch.arange(T, device=dev) % 2] = 1.0
        model.encoder.forward = lambda *a, **k: dataclasses.replace(real_encoder(*a, **k), logits=plan)
        try:
            out_k, out_p = (model(f, fl, labels=labels, label_lengths=label_lengths)
                            for f, fl in ((f_k, l_k), (f_p, l_p)))
        finally:
            model.encoder.forward = real_encoder
    if not torch.equal(out_k.asr_lengths, enc_p.logit_lengths) or not torch.equal(out_p.asr_lengths,
                                                                                   enc_p.logit_lengths):
        _fail("LLM-ASR: the common plan did not keep every valid frame")
    end = 1 + P + out_p.asr_lengths.long()
    first_k, first_p = (o.llm_logits[rows, end].float() for o in (out_k, out_p))
    err = float((first_k - first_p).abs().max())
    scale = max(1.0, float(first_p.abs().max()))
    ctc_err = float((enc_k.logits.float() - enc_p.logits.float()).abs().max())
    ctc_scale = max(1.0, float(enc_p.logits.float().abs().max()))
    valid = torch.arange(enc_p.logits.shape[1], device=dev)[None, :] < enc_p.logit_lengths[:, None]
    ctc_agree = float((enc_k.logits.argmax(-1) == enc_p.logits.argmax(-1))[valid].float().mean())
    print(f"  LLM-ASR greedy decode B=8 x 10 s, 16 tokens: kernel front end {ms_k:.1f} ms, plain {ms_p:.1f} ms "
          f"(median of 3, host clock); greedy tokens equal in {int((toks_k == toks_p).all(1).sum())} of 8 rows; "
          f"the encoder's CTC logits max |diff| {ctc_err:.4f} of scale {ctc_scale:.2f}, ids equal on "
          f"{100 * ctc_agree:.2f} % of valid frames (bar 98 %); surviving CTC frames a row, each route's own "
          f"plan: {own[0].tolist()} vs {own[1].tolist()}; first-step LLM logits under one plan keeping every "
          f"valid frame ({out_p.asr_lengths.tolist()}), each route's frames: max |diff| {err:.4f} of scale "
          f"{scale:.2f} (tol 0.05 x scale)", flush=True)
    if ctc_err > 0.05 * ctc_scale or ctc_agree < 0.98 or err > 0.05 * scale:
        _fail("the LLM-ASR kernel front end disagrees with the plain front end")
    del model, fused_route, plain_route
    torch.cuda.empty_cache()
    print(f"recipe phase: {time.perf_counter() - t_phase:.1f} s; decode-route launches {recipe_launches}", flush=True)
    return recipe_launches


def variants_phase(dev, smi, compare) -> dict:
    """The E-Branchformer variants, the streaming sessions and the CTC beam
    search on the card (step 17 of the module's docstring). ``compare`` is
    ``main``'s kernel-vs-plain hold, which keeps the new pieces' rows for the
    JSON line. Returns the kernel launches of the gated, csgu-linear request."""
    import torch
    import torch.nn.functional as F

    from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
    from huggingface_asr_tpu_torch.decoding.ctc_beam import CTCBeamConfig, ctc_beam_search
    from huggingface_asr_tpu_torch.decoding.generate import generate_joint
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels.train_attention import rel_attention_train, rel_attention_train_plain
    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.models.fast_infer import ctc_infer
    from huggingface_asr_tpu_torch.ops.ctc import ctc_greedy_decode
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig, LogMelFrontEnd
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.serving.streaming import StreamingCTCSession, StreamingJointSession
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_variants")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(17)

    class Pieces:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    def host_ms(fn, reps=3):
        out, times = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times

    # ---- (a) the gated front end and the CSGU linear on the kernel route
    cfg = flagship_config(context_awareness_type="gated", csgu_use_linear_after_conv=True)
    n_l = cfg.num_hidden_layers
    print(f"-- variants (a): the flagship with a gated front end and the CSGU linear, B=8 x 10 s through "
          f"ASRPipeline; {smi}", flush=True)
    model_dir = os.path.join(work, "gated_csgu_linear")
    save_params(seeded_model(cfg, seed=17), model_dir)
    pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=Pieces(), numeric_profile="exact")
    if not pipe._use_fused or pipe._fused.subsample is not None:
        _fail("the gated csgu-linear model did not take the fused route behind its own front end")
    audios = [speech(10.0 * (1.0 - 0.03 * i), rng) for i in range(8)]
    pipe(audios[:1])  # first call: warm the allocator
    per_layer = {"asr_layernorm_bf16": 1, "asr_gemm_bf16": 5, "asr_gemm_ln_bf16": 4, "asr_gemm_gate_bf16": 1,
                 "asr_rel_attention": 1, "asr_pos_query": 1, "dwconv_csgu_conv": 1, "dwconv_merge": 1}
    want = {"asr_log_mel": 1, "asr_cmvn": 1, **{k: v * n_l for k, v in per_layer.items()}}
    variant_launches, req_ms = {}, []
    for _ in range(3):
        texts, got = count_launches(lambda: pipe(audios), {})
        if got != want or len(texts) != 8:
            _fail(f"gated csgu-linear request: launches {got}, want {want}")
        variant_launches = got
    _, req_ms = host_ms(lambda: pipe(audios), reps=5)
    print(f"  request B=8 x 10 s: {float(np.median(req_ms)):.2f} ms median of 5 (host clock, synchronized; "
          f"{[round(t, 2) for t in req_ms]}); launches {variant_launches}", flush=True)
    against_plain_path(pipe, {"gated csgu-linear, 8 utt (10 s)": audios})
    # The >= 98 % bar on the greedy ids counts a frame whose ids differ at a
    # near-tie by the triage rule (top-two gap within TIE of the logit scale
    # on the plain route) as a tie. This seeded model's logits are flat
    # (median top-two gap ~0.15 of a scale of ~4): the plain layers alone
    # change ids between the two front ends' features (K3's and the plain
    # log-mel's, a bf16 ulp apart here and there), printed beside as the
    # yardstick.
    wav = torch.from_numpy(pipe._bucket_pad(audios)).to(dev)
    wav_lens = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        feats_k, flens_k = pipe._frontend(wav, wav_lens)
        enc = ctc_infer(pipe._fused, feats_k, flens_k)
        ref = ctc_infer(pipe._fused, *pipe._frontend(wav, wav_lens, plain=True), plain=True)
        nudged = ctc_infer(pipe._fused, feats_k, flens_k, plain=True)
    valid = torch.arange(ref.logits.shape[1], device=dev)[None, :] < ref.logit_lengths[:, None]
    r = ref.logits.float()
    top2 = r.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= TIE * float(r.abs()[valid].max())
    differ = (enc.logits.argmax(-1) != r.argmax(-1)) & valid
    frames = int(valid.sum())
    raw, held = 1.0 - int(differ.sum()) / frames, 1.0 - int((differ & ~tie).sum()) / frames
    self_agree = 1.0 - int(((nudged.logits.argmax(-1) != r.argmax(-1)) & valid).sum()) / frames
    print(f"  greedy ids equal on {100 * raw:.2f} % of {frames} valid frames, {100 * held:.2f} % with near-ties "
          f"(triage rule) as ties (bar 98 %); the plain layers on K3's features against the plain route: "
          f"{100 * self_agree:.2f} %", flush=True)
    if held < 0.98:
        _fail("gated csgu-linear: greedy ids equal on fewer than 98 % of the valid frames, ties aside")
    log_probs, lp_lens = F.log_softmax(enc.logits.float(), dim=-1), enc.logit_lengths

    # the two new pieces against their plain versions at B=8 and B=128, each
    # beside its bound and its library call (F.conv1d(groups=C) in bf16 without
    # the LayerNorm; F.linear without the epilogue); the ungated conv bit-equal
    # to the gated form where x_r is 1 and the activation the identity
    w = pipe._fused.layers[0]
    C, Kc = w["csgu_dw"].shape[1], w["csgu_dw"].shape[0]
    gen = torch.Generator().manual_seed(171)
    dev_ms = {}
    with torch.no_grad():
        for B_ in (8, 128):
            M, T_pad = B_ * 256, 256
            suffix = "" if B_ == 8 else "_b128"
            l = torch.randn(M, 2 * C, generator=gen).bfloat16().to(dev)
            cargs = (w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B_, T_pad, 250, 1e-5)
            gate_in = l[:, C:].reshape(B_, T_pad, C).transpose(1, 2)
            dw_c = w["csgu_dw"].t().reshape(C, 1, Kc).contiguous()
            conv = compare(f"dwconv csgu ungated B={B_}", f"dwconv_csgu_conv{suffix}",
                           lambda: K1.csgu_conv(l, *cargs), lambda: K1.csgu_conv_plain(l, *cargs), 2 ** -7,
                           library_fn=lambda: F.conv1d(gate_in, dw_c, padding=(Kc - 1) // 2, groups=C),
                           work=(2.0 * M * C * Kc + 10.0 * M * C, 2 * M * C + nbytes(w["csgu_dw"]) + 2 * M * C,
                                 "fp32"))
            ones = l.clone()
            ones[:, :C] = 1.0
            same = torch.equal(conv, K1.csgu(ones, *cargs[:-1], "identity", 1e-5))
            print(f"  ungated conv B={B_}: bit-equal to the gated form with x_r = 1: {same}", flush=True)
            if not same:
                _fail(f"the ungated CSGU conv at B={B_} is not bit-equal to the gated form's")
            lin_w, lin_b = w["csgu_lin_w"], w["csgu_lin_b"]
            x_r = l[:, :C]
            w_t, b16 = lin_w.t(), lin_b.bfloat16()
            compare(f"gemm gate epilogue M={M}", f"gemm_gate{'' if B_ == 8 else '_m32768'}",
                    lambda: K1.gemm(conv, lin_w, lin_b, act=cfg.csgu_activation, gate=x_r),
                    lambda: K1.gemm_plain(conv, lin_w, lin_b, act=cfg.csgu_activation, gate=x_r), 2 ** -6,
                    library_fn=lambda: F.linear(conv, w_t, b16),
                    work=(2.0 * M * C * C, nbytes(conv, lin_w, lin_b) + 2 * M * C + 2 * M * C, "bf16"))
            for act in ("gelu", "swish"):
                compare(f"gemm gate epilogue M={M} {act}", None,
                        lambda: K1.gemm(conv, lin_w, lin_b, act=act, gate=x_r),
                        lambda: K1.gemm_plain(conv, lin_w, lin_b, act=act, gate=x_r), 2 ** -6, iters=4)
            dev_ms.update({
                f"ungated conv B={B_}": device_ms(lambda: K1.csgu_conv(l, *cargs)),
                f"gated conv B={B_}": device_ms(lambda: K1.csgu(l, *cargs[:-1], "identity", 1e-5)),
                f"F.conv1d B={B_}": device_ms(lambda: F.conv1d(gate_in, dw_c, padding=(Kc - 1) // 2, groups=C)),
                f"gate GEMM M={M}": device_ms(lambda: K1.gemm(conv, lin_w, lin_b, act=cfg.csgu_activation,
                                                              gate=x_r)),
                f"plain-epilogue GEMM M={M}": device_ms(lambda: K1.gemm(conv, lin_w, lin_b)),
                f"F.linear M={M}": device_ms(lambda: F.linear(conv, w_t, b16)),
            })
            del l, ones, conv, gate_in
    print("  device ms under the profiler: " + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)
    del pipe
    # the same request in the serving profile: the CSGU linear keeps its exact
    # activation (JAX's CSGU act is fp32), the other GELUs and the attention serve
    pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=Pieces(), numeric_profile="serving")
    pipe(audios[:1])
    texts, got = count_launches(lambda: pipe(audios), {})
    want_s = {"asr_log_mel_bf16": 1, "asr_gemm_gate_bf16": n_l, "dwconv_csgu_conv": n_l,
              "asr_rel_attention_serving": n_l, "asr_gemm_ln_gelu_serving": 3 * n_l}
    print(f"  serving profile, request B=8 x 10 s: launches {got}", flush=True)
    if len(texts) != 8 or any(got.get(k, 0) != v for k, v in want_s.items()):
        _fail(f"gated csgu-linear request, serving profile: launches {got}, want {want_s}")
    against_plain_path(pipe, {"gated csgu-linear, serving, 8 utt (10 s)": audios})
    del pipe
    torch.cuda.empty_cache()

    # ---- (f) the CTC beam search on (a)'s log-probs, on the card and on the CPU
    bcfg = CTCBeamConfig(beam_size=10, beam_size_token=16)
    got, beam_ms = host_ms(lambda: ctc_beam_search(log_probs, lp_lens, bcfg))
    t0 = time.perf_counter()
    ref = ctc_beam_search(log_probs.cpu(), lp_lens.cpu(), bcfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    ids_same = torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    score_err = float((got[2].cpu() - ref[2]).abs().max())
    print(f"-- variants (f): ctc_beam_search W=10, K=16 on (a)'s log-probs (B=8, T={log_probs.shape[1]}, "
          f"V={log_probs.shape[2]}): {float(np.median(beam_ms)):.1f} ms on the card (median of 3, "
          f"{[round(t, 1) for t in beam_ms]}), {cpu_ms:.1f} ms on the host's CPU; n-best ids equal {ids_same}, "
          f"scores max |diff| {score_err:.2e} (tol 1e-3); best lengths {got[1][:, 0].tolist()}", flush=True)
    if not ids_same or score_err > 1e-3 or not bool(torch.isfinite(got[2]).all()):
        _fail("ctc_beam_search on the card disagrees with the CPU")

    # ---- (b) two CTCTrainer steps of the same model under "auto": K4 on the card
    tcfg = dataclasses.replace(cfg, attention_impl="auto", attention_dropout=0.1)
    print(f"-- variants (b): training, attention_impl 'auto', B=32 x 9.3-10 s, bf16; {smi}", flush=True)
    trainer, batches = training_setup(seed=17, batch_size=32, n_batches=2, cfg=tcfg)
    twin = copy.deepcopy(trainer.model)
    state = trainer.init_state()
    logged = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        (state, m), step_l = count_launches(lambda: trainer.train_step(state, batch), {})
        step_ms = (time.perf_counter() - t0) * 1e3
        logged.append({k: float(v) for k, v in m.items() if k in ("loss", "grad_norm", "step_applied")})
        print(f"  step {i + 1}: loss={logged[-1]['loss']:.4f} grad_norm={logged[-1]['grad_norm']:.3f} "
              f"applied={int(logged[-1]['step_applied'])} {step_ms:.1f} ms (host clock, synchronized); K4 launches "
              f"{step_l.get('asr_rel_attention_train_fwd', 0)} fwd, {step_l.get('asr_rel_attention_train_bwd', 0)} bwd",
              flush=True)
        if any(step_l.get(k, 0) != n_l for k in ("asr_rel_attention_train_fwd", "asr_rel_attention_train_bwd")):
            _fail(f"variants step {i + 1}: K4 launches {step_l}, want {n_l} of each")
        if int(logged[-1]["step_applied"]) != 1 or not np.isfinite(logged[-1]["loss"]):
            _fail(f"variants step {i + 1} was not applied or its loss is not finite")
    plain, _ = training_setup(seed=17, batch_size=32, n_batches=0, cfg=tcfg)
    plain.model.load_state_dict(twin.state_dict())
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        _, m_plain = plain.train_step(plain.init_state(), batches[0])
    finally:
        model_module.rel_attention_train = rel_attention_train
    d_loss = abs(logged[0]["loss"] - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    print(f"  step 1, kernels vs plain attention: loss {logged[0]['loss']:.6f} vs {float(m_plain['loss']):.6f} "
          f"(rel {d_loss:.2e}, tol 1e-4)", flush=True)
    if d_loss > 1e-4:
        _fail("variants step 1 with the attention kernels disagrees with the plain-attention step")
    del trainer, plain, twin, state, batches
    torch.cuda.empty_cache()

    # ---- (c) rotary positions: one B=8 request on the plain route
    rcfg = flagship_config(position_embeddings_type="rotary")
    print("-- variants (c): the flagship with rotary positions, B=8 x 10 s on the plain route", flush=True)
    r_model = seeded_model(rcfg, seed=18)
    r_dir = os.path.join(work, "rotary")
    save_params(r_model, r_dir)
    r_pipe = ASRPipeline(r_dir, model_type="ctc", device="cuda", tokenizer=Pieces())
    if r_pipe._use_fused:
        _fail("the rotary model took the fused route")
    texts, r_launches = count_launches(lambda: r_pipe(audios), {})
    _, r_ms = host_ms(lambda: r_pipe(audios))
    with torch.inference_mode():
        feats, flens = r_pipe._frontend(wav, wav_lens)
        got_r = r_pipe._model(feats.to(torch.bfloat16), flens)
        ref_r = r_model.to(dev)(feats, flens)
    valid = torch.arange(ref_r.logits.shape[1], device=dev)[None, :] < ref_r.logit_lengths[:, None]
    r_err = float((got_r.logits.float() - ref_r.logits).abs()[valid].max())
    r_scale = max(1.0, float(ref_r.logits.abs()[valid].max()))
    print(f"  request {float(np.median(r_ms)):.2f} ms median of 3 ({[round(t, 2) for t in r_ms]}); launches "
          f"{r_launches}; bf16 logits vs the fp32 model max |diff| {r_err:.4f} of scale {r_scale:.2f} "
          f"(tol 0.05 x scale)", flush=True)
    if len(texts) != 8 or r_launches or r_err > 0.05 * r_scale or not bool(torch.isfinite(got_r.logits).all()):
        _fail("the rotary model's plain route failed")
    del r_pipe, r_model
    torch.cuda.empty_cache()

    # ---- (d) streaming CTC: a causal flagship (fp32) behind a global-CMVN front end, 10 s in 1 s feeds
    mel_rng = np.random.default_rng(19)
    means, stds = mel_rng.standard_normal(80) * 0.5 - 4.0, mel_rng.uniform(2.0, 4.0, 80)
    frontend = LogMelFrontEnd(LogMelConfig(norm_type="global"), global_means=means, global_stds=stds)
    s_model = seeded_model(flagship_config(is_causal=True), seed=19).to(dev)
    audio = speech(10.0, rng)
    session = StreamingCTCSession(s_model, frontend, device="cuda")
    print("-- variants (d): StreamingCTCSession, causal flagship (fp32), global CMVN, 10 s in 1 s feeds", flush=True)

    def logits_of(n):
        """The session's logits for the first n samples (its bucket padding)."""
        b = session._bucketed(n)
        x = torch.zeros(1, b, device=dev)
        x[0, :n] = torch.from_numpy(audio[:n]).to(dev)
        with torch.inference_mode():
            out = s_model(*frontend(x, torch.tensor([n], dtype=torch.int32, device=dev)))
        return out.logits[0].float(), int(out.logit_lengths[0])

    feeds, feed_ms = [], []
    for k in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feeds.append(session.feed(audio[k * 16000:(k + 1) * 16000]))
        torch.cuda.synchronize()
        feed_ms.append((time.perf_counter() - t0) * 1e3)
    ties = 0
    for k in range(1, 10):
        prev, cur = feeds[k - 1], feeds[k]
        if cur[:len(prev)] == prev:
            continue
        # the triage rule: where the two feeds' greedy ids part, the top-two
        # logit gap must be within 2^-7 of the logit scale on one side
        a, na = logits_of(k * 16000)
        b, nb = logits_of((k + 1) * 16000)
        n = min(na, nb)
        diff = (a[:n].argmax(-1) != b[:n].argmax(-1)).nonzero()
        if not len(diff):
            _fail(f"streaming feed {k + 1} does not extend feed {k}, with equal frame ids")
        f = int(diff[0])
        gaps = [float(t[f].topk(2).values[0] - t[f].topk(2).values[1]) for t in (a, b)]
        scale = max(1.0, float(b[:n].abs().max()))
        print(f"  feed {k + 1} parts from feed {k} at frame {f}: top-two gaps {gaps[0]:.2e}, {gaps[1]:.2e} of "
              f"scale {scale:.2f}", flush=True)
        if min(gaps) > TIE * scale:
            _fail(f"streaming feed {k + 1} does not extend feed {k} (no near-tie)")
        ties += 1
    one_shot = StreamingCTCSession(s_model, frontend, device="cuda").feed(audio)
    with torch.inference_mode():
        x = torch.from_numpy(audio)[None].to(dev)
        out = s_model(*frontend(x, torch.tensor([len(audio)], dtype=torch.int32, device=dev)))
        toks, tl = ctc_greedy_decode(out.logits, out.logit_lengths)
    unpadded = toks[0, :int(tl[0])].tolist()
    print(f"  {len(feeds[-1])} tokens after 10 feeds; ms a feed {[round(t, 1) for t in feed_ms]} (host clock, "
          f"synchronized; median {float(np.median(feed_ms)):.1f}); {ties} feeds parted at near-ties; the last feed "
          f"equals the one-shot session decode: {feeds[-1] == one_shot}, the unpadded decode: {feeds[-1] == unpadded}",
          flush=True)
    if feeds[-1] != one_shot or not feeds[-1]:
        _fail("the last streaming feed differs from a one-shot decode of the whole audio")
    del session, s_model
    torch.cuda.empty_cache()

    # ---- (e) streaming joint decoding: decred_base with a causal encoder (fp32), three 2 s feeds
    base = aed_config()
    joint = aed_model(20, dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, is_causal=True))).to(dev)
    gen_cfg = BeamSearchConfig(num_beams=5, max_length=32, ctc_weight=0.3, bos_token_id=0, eos_token_id=1,
                               pad_token_id=3)
    j_audio = speech(6.0, rng)
    j_session = StreamingJointSession(joint, frontend, gen_cfg, device="cuda")
    print(f"-- variants (e): StreamingJointSession, {AED_CONFIG} with a causal encoder (fp32), 5 beams, max "
          f"length 32, three 2 s feeds", flush=True)
    j_feeds, j_ms = [], []
    for k in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        j_feeds.append(j_session.feed(j_audio[k * 32000:(k + 1) * 32000]))
        torch.cuda.synchronize()
        j_ms.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        x = torch.from_numpy(j_audio)[None].to(dev)
        seqs, _ = generate_joint(joint, *frontend(x, torch.tensor([len(j_audio)], dtype=torch.int32, device=dev)),
                                 gen_cfg)
    whole = [int(t) for t in seqs[0, 0].tolist() if int(t) not in (0, 1, 3)]
    print(f"  feeds: {[len(f) for f in j_feeds]} tokens, {[round(t, 1) for t in j_ms]} ms (host clock, "
          f"synchronized); the last feed equals generate_joint on the whole audio: {j_feeds[-1] == whole}", flush=True)
    if j_feeds[-1] != whole:
        _fail("the last joint streaming feed differs from generate_joint on the whole audio")
    del joint, j_session
    torch.cuda.empty_cache()
    print(f"variants phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return variant_launches


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tools_phase(dev, smi) -> tuple:
    """The statistics CLI on K3, data-parallel training under a one-rank NCCL
    process group (with and without ``--fsdp``), the profiler capture, the
    native collator and the publisher (step 18 of the module's docstring).
    Returns (the statistics CLI's launches, the process-group runs' launches)."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from huggingface_asr_tpu_torch.cli import compute_dataset_statistics as stats_cli
    from huggingface_asr_tpu_torch.cli import train_ctc
    from huggingface_asr_tpu_torch.cli.common import eval_batches
    from huggingface_asr_tpu_torch.data import native_collate
    from huggingface_asr_tpu_torch.data.bucketing import BucketingConfig
    from huggingface_asr_tpu_torch.data.collator import CollatorConfig, SpeechCollator
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.data.synthetic_speech import utterance
    from huggingface_asr_tpu_torch.interop.publish import build_hub_repo
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        GenerationArguments,
        ModelArguments,
    )
    from huggingface_asr_tpu_torch.training.model_factory import load_ctc_model
    from huggingface_asr_tpu_torch.utils.argparsing import DataclassArgumentParser

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(18)

    # ---- (a) the statistics CLI on K3: 64 utterances of 2-15 s, batches of 16
    audio = [speech(rng.uniform(2.0, 15.0), rng) for _ in range(64)]
    table = ColumnTable({"audio": audio, "text": [""] * 64, "input_len": [len(a) / 16000 for a in audio]})
    args = stats_cli.StatsArguments(output_dir=os.path.join(work, "stats"), batch_size=16, device="cuda")
    t0 = time.perf_counter()
    (mean, std), stats_launches = count_launches(lambda: stats_cli.run(args, table), {})
    stats_s = time.perf_counter() - t0
    # the reference: the same batches through the kernel's plain version in fp64, and the
    # largest fp32 plain log-mel error against it (the kernel's fp64 gate holds each
    # log-mel value within twice that; a mean or a std of such values moves by as much)
    fe = K3.MelFrontEnd(LogMelConfig(norm_type="none"), device=dev)
    cfg = fe.config
    collator = SpeechCollator(CollatorConfig(bucketing=BucketingConfig(batch_size=16, pad_to_multiple=16000)))
    total = np.zeros(cfg.num_mel_bins)
    total_sq = np.zeros_like(total)
    count, err32 = 0.0, 0.0
    for batch in eval_batches(table, collator, 16):
        n = int(batch.pop("_num_real"))
        wav = torch.from_numpy(batch["input_values"][:n]).to(dev)
        n_frames = int(cfg.num_frames(wav.shape[1]))
        frames = cfg.num_frames(torch.from_numpy(batch["input_values_lengths"][:n]).to(dev).long())
        valid = (torch.arange(n_frames, device=dev)[None, :] < frames[:, None])[..., None]
        exact = K3.log_mel_plain(wav.double(), n_frames, fe.dft.double(), fe.mel.double(), cfg.hop_length,
                                 cfg.mel_floor)
        plain = K3.log_mel_plain(wav, n_frames, fe.dft, fe.mel, cfg.hop_length, cfg.mel_floor)
        err32 = max(err32, float(((plain.double() - exact).abs() * valid).max()))
        total += (exact * valid).sum(dim=(0, 1)).cpu().numpy()
        total_sq += (exact.square() * valid).sum(dim=(0, 1)).cpu().numpy()
        count += float(valid.sum())
    ref_mean = total / count
    ref_std = np.sqrt(total_sq / count - np.square(ref_mean))
    d_mean, d_std = float(np.abs(mean - ref_mean).max()), float(np.abs(std - ref_std).max())
    tol = 2.0 * err32
    print(f"-- tools phase (a): compute_dataset_statistics.run on K3, 64 utterances of 2-15 s "
          f"({sum(len(a) for a in audio) / 16000:.1f} s) in batches of 16: {stats_s:.2f} s, launches "
          f"{stats_launches}; means {mean.min():.3f}..{mean.max():.3f}, stds {std.min():.3f}..{std.max():.3f}; "
          f"largest error against the fp64 statistics: mean {d_mean:.3e}, std {d_std:.3e} (tolerance "
          f"2 x {err32:.3e}, twice the fp32 plain log-mel's largest error); {smi}", flush=True)
    if stats_launches.get("asr_log_mel", 0) != 4 or stats_launches.get("asr_cmvn", 0):
        _fail(f"statistics CLI: launches {stats_launches}, want 4 of asr_log_mel and no asr_cmvn")
    if not (d_mean <= tol and d_std <= tol):
        _fail("statistics CLI: the K3 statistics are outside twice the fp32 plain error of the fp64 statistics")
    for name in ("global_means.npy", "global_stds.npy", "global_stats.json"):
        if not os.path.exists(os.path.join(args.output_dir, name)):
            _fail(f"statistics CLI: no {name}")

    # ---- (b) train_ctc.run, flagship, 3 steps of 32 x 9.3-10 s: twice alone, then under a
    # one-rank NCCL process group with --fsdp off and on
    tok = IdTokenizer()
    model_cfg = flagship_config(vocab_size=len(tok), attention_impl="pallas")
    with open(os.path.join(work, "model.json"), "w") as f:
        f.write(model_cfg.to_json())

    def split(n):
        cols = {"audio": [], "text": [], "input_len": []}
        for _ in range(n):
            wav, text = utterance(rng.uniform(9.3, 10.0), rng)
            cols["audio"].append(wav)
            cols["text"].append(text)
            cols["input_len"].append(len(wav) / 16000)
        return ColumnTable(cols)

    dataset = {"train": split(32), "validation": split(16), "test": split(16)}
    pg_launches = {}

    def train(name, *flags, into=None):
        out = os.path.join(work, name)
        argv = ["--model_config", os.path.join(work, "model.json"), "--output_dir", out,
                "--per_device_train_batch_size", "32", "--per_device_eval_batch_size", "16", "--max_steps", "3",
                "--logging_steps", "1", "--eval_steps", "3", "--save_steps", "1000", "--warmup_steps", "2",
                "--learning_rate", "5e-4", "--pad_to_multiple", "100", "--no-apply_spec_augment", *flags]
        groups = [ModelArguments, GeneralTrainingArguments, GenerationArguments, DataConfig]
        parsed = DataclassArgumentParser(groups).parse_args_into_dataclasses(argv)
        t0 = time.perf_counter()
        _, launches = count_launches(lambda: train_ctc.run(*parsed, dataset, tok), {} if into is None else into)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        steps = [(r["loss"], r["grad_norm"], int(r["step_applied"])) for r in logged if "loss" in r]
        print(f"  train_ctc {name}: {time.perf_counter() - t0:.1f} s; (loss, grad_norm, applied) "
              f"{[(repr(a), repr(b), c) for a, b, c in steps]}; launches {launches}", flush=True)
        n_l = model_cfg.num_hidden_layers
        want = {"asr_rel_attention_train_fwd": 3 * n_l, "asr_rel_attention_train_bwd": 3 * n_l}
        if len(steps) != 3 or any(not np.isfinite(a) or c != 1 for a, _, c in steps):
            _fail(f"train_ctc {name}: not 3 applied steps with finite losses")
        if any(launches.get(k, 0) != v for k, v in want.items()) or launches.get("asr_rel_attention_shift", 0) < n_l:
            _fail(f"train_ctc {name}: launches {launches}, want {want} and K5 in the evaluation")
        return out, steps

    print("-- tools phase (b): train_ctc.run, flagship, 3 steps of 32 x 9.3-10 s, no SpecAugment "
          "(dropout on), attention_impl 'pallas': twice without a process group, then under a one-rank "
          "NCCL group with --fsdp off and on", flush=True)
    _, alone = train("alone")
    _, alone2 = train("alone_again")
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0")
    try:
        final_dir, grouped = train("group", into=pg_launches)
        if not dist.is_initialized() or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            _fail("train_ctc under the process group: no one-rank NCCL group was joined")
        _, sharded = train("group_fsdp", "--fsdp", into=pg_launches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k, None)
    # The step is deterministic but for F.ctc_loss's CUDA backward, which adds with atomics
    # (PyTorch names ctc_loss_backward_gpu as having no deterministic implementation): its
    # gradients move by ~1e-11 between runs, and at times a step's gradient norm by an fp32
    # ulp, at times not at all. So two runs alone may agree bit for bit and a third differ by
    # an ulp; each step's loss and gradient norm is held within the larger of the two runs'
    # spread and 8 fp32 ulps of the value (a fault of the grouped step, a row, a shard or a
    # gather, moves them by 1e-3 or more). Step 1's loss comes before any gradient and is
    # bit-equal in every run.
    spread = [[abs(a[i] - b[i]) for a, b in zip(alone, alone2)] for i in (0, 1)]
    tol = [[max(d, 8 * float(np.spacing(np.float32(a[i])))) for d, a in zip(spread[i], alone)] for i in (0, 1)]
    for name, run in (("group", grouped), ("group_fsdp", sharded)):
        gaps = [[abs(a[i] - b[i]) for a, b in zip(alone, run)] for i in (0, 1)]
        print(f"  {name} against alone, steps 1-3: loss gaps {[f'{g:.3e}' for g in gaps[0]]}, gradient norm "
              f"gaps {[f'{g:.3e}' for g in gaps[1]]} (spread of two runs alone: {[f'{g:.3e}' for g in spread[0]]}, "
              f"{[f'{g:.3e}' for g in spread[1]]}; tolerances {[f'{g:.3e}' for g in tol[0]]}, "
              f"{[f'{g:.3e}' for g in tol[1]]}; {'bit-equal' if not any(gaps[0] + gaps[1]) else 'not bit-equal'})",
              flush=True)
        if gaps[0][0] != 0.0:
            _fail(f"train_ctc {name}: step 1's loss differs from the run alone")
        if any(g > t for i in (0, 1) for g, t in zip(gaps[i], tol[i])):
            _fail(f"train_ctc {name}: losses or gradient norms outside the spread of two runs alone "
                  "and 8 ulps")

    # ---- (c) the profiler capture of steps 1-2 of the same trainer (CTCTrainer, flagship, 32 x 10 s)
    trainer, batches = training_setup(seed=5, batch_size=32, n_batches=4)
    profile_dir = os.path.join(work, "profile")
    trainer.config = dc.replace(trainer.config, profile_steps=2, profile_start=1, profile_dir=profile_dir)
    t0 = time.perf_counter()
    trainer.fit(trainer.init_state(), iter(batches))
    trace = os.path.join(profile_dir, "trace_rank0.json")
    if not os.path.exists(trace):
        _fail(f"profile_steps: no trace at {trace}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    k4 = sorted(n for n in kernels if "train_fwd" in n or "train_bwd" in n)
    gemms = sorted(n for n in kernels if "gemm" in n.lower() or n.startswith("nvjet"))
    print(f"-- tools phase (c): profile_steps=2 from step 1: {time.perf_counter() - t0:.1f} s, trace "
          f"{os.path.getsize(trace) / 1e6:.1f} MB, {len(kernels)} kernel names, K4's {[n[:60] for n in k4]}, "
          f"{len(gemms)} GEMM names, e.g. {[n[:60] for n in gemms[:2]]}", flush=True)
    if not any("train_fwd" in n for n in k4) or not any("train_bwd" in n for n in k4) or not gemms:
        _fail("profile_steps: the trace does not name K4's forward and backward kernels and a GEMM")
    del trainer, batches
    torch.cuda.empty_cache()

    # ---- (d) the native collator: built by g++ under build/torch_native and in use
    built = sorted(os.listdir(native_collate.BUILD_DIR)) if native_collate.BUILD_DIR.exists() else []
    print(f"-- tools phase (d): native collator in use: {native_collate.using_native()}, built {built}",
          flush=True)
    if not native_collate.using_native() or not any(n.startswith("libcollate_") for n in built):
        _fail("the native collator was not built by g++ or is not in use")

    # ---- (e) build_hub_repo from (b)'s final/, loaded back strictly: the same logits
    repo = build_hub_repo(os.path.join(final_dir, "final"), os.path.join(work, "hub_repo"), model_type="ctc",
                          repo_name="user/flagship-ctc")
    model = load_ctc_model(os.path.join(final_dir, "final"), device=dev)
    twin = load_ctc_model(os.path.join(final_dir, "final"), device=dev)
    twin.load_state_dict(torch.load(os.path.join(repo, "pytorch_model.bin"), weights_only=True), strict=True)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 998, 80)).astype(np.float32)).to(dev)
    lens = torch.tensor([998, 900, 700, 500], dtype=torch.int32, device=dev)
    with torch.no_grad():
        a, b = model(feats, lens).logits, twin(feats, lens).logits
    with open(os.path.join(repo, "config.json")) as f:
        hub_cfg = json.load(f)
    print(f"-- tools phase (e): hub repo {sorted(os.listdir(repo))}, architectures {hub_cfg['architectures']}; "
          f"logits of the loaded-back weights equal: {bool(torch.equal(a, b))}", flush=True)
    if not torch.equal(a, b):
        _fail("the hub repo's weights give other logits than final/'s")
    del model, twin
    torch.cuda.empty_cache()
    print(f"tools phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return stats_launches, pg_launches


def timed(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` windows of the mean ms of ``iters`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / iters)
    return float(np.median(windows))


def host_us_per_launch(fn, n: int = 300) -> float:
    """Host time in us of one call of ``fn``, a kernel wrapper at a shape so
    small that the device never falls behind."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * dt / n


TRACE_PAD_S = 0.02  # host time before the first call and after the last in every device_ms trace


def device_kernel_ms(fn, n: int = 10, tries: int = 3) -> dict:
    """{kernel name: device ms per call of ``fn``}, from the kernels' own
    durations under ``torch.profiler`` over ``n`` calls: each name's mean
    duration times its records per call. A trace can drop kernel records
    (``profile_kernel_variants.py trace`` counts them): with the calls right
    at its edges, all of them at times (the device records' times can sit
    milliseconds off the host's); and late in a long process one a trace. So
    the calls start and end ``TRACE_PAD_S`` inside the trace; a trace that
    still holds fewer records than the host launched kernels says so, with the
    launches' and the records' start times, and the means stand; a trace with
    no record is taken again, and after ``tries`` of them the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        events = prof.events()
        records = [ev for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA]
        launches = [ev for ev in events if "Launch" in ev.name]
        if len(records) < len(launches):
            at = lambda evs: [round(ev.time_range.start) for ev in sorted(evs, key=lambda e: e.time_range.start)]  # noqa: E731
            print(f"    device_ms: {len(records)} kernel records for {len(launches)} host launch records; launches "
                  f"at {at(launches)} us, records at {at(records)} us", flush=True)
        if records:
            per_name = {}
            for ev in records:
                per_name.setdefault(ev.name, []).append(ev.time_range.end - ev.time_range.start)
            return {k: float(np.mean(d)) * max(1, round(len(d) / n)) / 1e3 for k, d in per_name.items()}
    _fail(f"the profiler held no kernel record in {tries} traces in a row")


def device_ms(fn, n: int = 10, name=None) -> float:
    """Device time of one call of ``fn`` in ms (``device_kernel_ms``), of
    the kernels whose name holds ``name`` where it is given. Unlike a pair of
    events around the calls it leaves out the host's time per launch, which
    at small shapes is the larger part."""
    return sum(v for k, v in device_kernel_ms(fn, n).items() if name is None or name in k)


def sdpa_call(q_u, q_rot, k, v, k_std, lengths, scale):
    """The library yardstick of the attention kernels:
    ``F.scaled_dot_product_attention`` on the concatenated operands
    ``[q_u | q_rot]`` and ``[k | k_std]`` with a boolean key mask (a zero-length
    row attends to every key) at dropout rate 0. Returns (a forward call, a
    function that builds a backward call for a seeded dO)."""
    import torch
    import torch.nn.functional as F

    B, T, H, _ = q_u.shape
    heads_first = lambda t: t.detach().transpose(1, 2).contiguous()  # noqa: E731
    q = heads_first(torch.cat([q_u, q_rot], dim=-1))
    kk = heads_first(torch.cat([k, k_std[None, :, None, :].expand(B, T, H, -1)], dim=-1))
    vv = heads_first(v)
    n_keys = torch.where(lengths > 0, lengths, T)
    mask = (torch.arange(T, device=q.device)[None, :] < n_keys[:, None])[:, None, None, :]

    def forward():
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask, scale=scale)

    def make_backward():
        leaves = [t.clone().requires_grad_(True) for t in (q, kk, vv)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(out)
        return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)

    return forward, make_backward


def pos_query_library(q_v, wp):
    """The library yardstick of the positional query: one ``torch.bmm`` of the
    per-head product, q_v_h (M, dh) x [wp_e | wp_o][h] (dh, D) for the H heads,
    without the rotation the kernel fuses."""
    import torch

    H, _, dh = wp.shape
    qv = q_v.reshape(-1, H, dh).transpose(0, 1).contiguous()
    w = wp.transpose(1, 2).contiguous()
    return lambda: torch.bmm(qv, w)


def mel_bf16_work(wav, n_frames: int, bases, mel):
    """(operations, bytes, type) of the bf16 log-mel kernel: the waveform,
    bases and log-mel moved once; of its two kinds of operations, the DFT's
    bf16 products (three in "high") and the fp32 mel product over the bank's
    nonzero weights, the one that takes the card longer at its own peak (the
    two run on different units)."""
    B = wav.shape[0]
    P, two_nb, L = bases.shape
    dft = 2.0 * B * n_frames * L * two_nb * (3 if P == 2 else 1)
    mel_ops = 2.0 * B * n_frames * int((mel != 0).sum())
    moved = nbytes(wav, bases, mel) + 4 * B * n_frames * mel.shape[1]
    if dft / PEAK_FLOPS["bf16"] >= mel_ops / PEAK_FLOPS["fp32"]:
        return dft, moved, "bf16"
    return mel_ops, moved, "fp32"


class IdsRecorder:
    """A stand-in tokenizer that records the ids it decodes."""

    def __init__(self):
        self.ids = []

    def decode(self, ids, skip_special_tokens=True):
        self.ids.append([int(t) for t in ids])
        return " ".join(map(str, self.ids[-1]))


SERVING_KERNELS = ("asr_log_mel_bf16", "asr_conv1_serving", "asr_conv2_serving", "asr_gemm_ln_gelu_serving",
                   "asr_rel_attention_serving")
EXACT_KERNELS = ("asr_log_mel", "asr_conv1", "asr_conv2", "asr_rel_attention")


def serving_phase(dev, smi, compare, ln_gemm_hold, fused, model_dir, requests, B_big: int = 128,
                  S: int = 160000) -> tuple:
    """The serving profile on the card (step 19 of the module's docstring),
    with ``fused`` and ``model_dir`` the flagship's and its requests, at B=8
    and ``B_big`` x ``S`` samples; ``compare`` and ``ln_gemm_hold`` are
    ``main``'s. Returns (the serving flagship requests' launches, the "high"
    front end's launches, the gate's counts of JAX ids)."""
    import torch
    import torch.nn.functional as F

    from huggingface_asr_tpu_torch.data.synthetic_speech import corpus_rows
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.kernels import subsample as K2
    from huggingface_asr_tpu_torch.models.ebranchformer import feat_extract_output_frames
    from huggingface_asr_tpu_torch.models.fast_infer import ctc_infer
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline

    t_phase = time.perf_counter()
    cfg = fused.config
    base = LogMelConfig(num_mel_bins=cfg.num_fbanks)
    dft_np, mel_np = K3.folded_bases(base)
    dft32, mel32 = torch.from_numpy(dft_np).to(dev), torch.from_numpy(mel_np).to(dev)
    hop, floor, L = base.hop_length, base.mel_floor, base.frame_length
    n = int(base.num_frames(S))
    gen = np.random.default_rng(19)
    wavs = np.zeros((B_big, S), np.float32)
    lens = [int(S * (1.0 - 0.005 * (i % 16))) for i in range(B_big)]
    for i in range(B_big):
        wv = speech(lens[i] / 16000, gen)
        wavs[i, :len(wv)] = wv
    wav_big = torch.from_numpy(wavs).to(dev)
    del wavs

    # ---- (a) K3's bf16 and high DFT modes at B=8 and 128 x 10 s, beside the fp32
    # kernel's time and cuBLAS's bf16 product of the same framed operands (the
    # library call: it computes the DFT's product alone, not the power, mel and
    # log); their log-mel errors against the folded product in fp64
    print(f"-- serving (a): the log-mel kernel's bf16 and high DFT modes, B=8 and {B_big} x {S} samples "
          f"(T_in={n}); {smi}",
          flush=True)
    bases = {mode: K3.split_bases(dft_np, mode).to(dev) for mode in ("bf16", "high")}
    with torch.no_grad():
        for B in (8, B_big):
            wav = wav_big[:B]
            exact = K3.log_mel_plain(wav.double(), n, dft32.double(), mel32.double(), hop, floor)
            fp32_err = float((K3.log_mel_plain(wav, n, dft32, mel32, hop, floor).double() - exact).abs().max())
            fp32_ms = timed(lambda: K3.log_mel(wav, n, dft32, mel32, hop, floor))
            for mode, bs in bases.items():
                args = (n, bs, mel32, hop, floor, mode)
                frames16 = wav.unfold(1, L, hop)[:, :n].to(torch.bfloat16).contiguous()
                hi_t = bs[0].t()
                key = f"mel_{mode}" + ("_b128" if B != 8 else "")
                got = compare(f"mel {mode} B={B}", key, lambda: K3.log_mel(wav, *args),
                              lambda: K3.log_mel_plain(wav, *args), 1e-3, library_fn=lambda: frames16 @ hi_t,
                              work=mel_bf16_work(wav, n, bs, mel32))
                err_k = float((got.double() - exact).abs().max())
                err_p = float((K3.log_mel_plain(wav, *args).double() - exact).abs().max())
                print(f"    against fp64: kernel {err_k:.3e}, plain {mode} {err_p:.3e}, fp32 plain (cuBLAS) "
                      f"{fp32_err:.3e}; device ms under the profiler {device_ms(lambda: K3.log_mel(wav, *args)):.4f} "
                      f"(fp32 kernel {fp32_ms:.4f} on events, cuBLAS bf16 product "
                      f"{device_ms(lambda: frames16 @ hi_t):.4f})", flush=True)
                if not err_k <= 1.25 * err_p:
                    _fail(f"mel {mode} B={B}: largest log-mel error against fp64 {err_k:.3e}, past 1.25x the "
                          f"plain {mode} version's {err_p:.3e}")
                del frames16, got
            del exact
            torch.cuda.empty_cache()

    # ---- (b) the serving pieces of K2 and K1 at the B=8 x 10 s request's shapes,
    # each beside its exact form's time; conv1 also at B=128
    print(f"-- serving (b): conv1 (also at B={B_big}), conv2, the GEMM's serving GELU epilogue (also at M = 32,768), "
          "rel_attention, the layer, B=8", flush=True)
    wav8 = wav_big[:8]
    lens8 = torch.tensor(lens[:8], dtype=torch.int32, device=dev)
    front = K3.MelFrontEnd(dataclasses.replace(base, matmul_precision="bf16"), device=dev)
    sw, w = fused.subsample, fused.layers[0]
    C, D, H = cfg.conv_dim[0], cfg.hidden_size, cfg.num_attention_heads
    T = int(feat_extract_output_frames(cfg, n))
    T_pad = -(-T // 8) * 8
    with torch.no_grad():
        for B, wv, ln in ((8, wav8, lens8), (B_big, wav_big, torch.tensor(lens, dtype=torch.int32, device=dev))):
            feats, feat_lens = front(wv, ln)
            T1 = (n + 1) // 2
            work1 = (2.0 * 9 * C * B * T1 * (cfg.num_fbanks // 2),
                     nbytes(feats, sw["w1"], sw["b1"]) + 2 * C * B * T1 * (cfg.num_fbanks // 2), "bf16")
            cw1 = sw["w1"].t().reshape(C, 1, 3, 3)
            y1 = compare(f"conv1 serving B={B}", "conv1_serving" + ("_b128" if B != 8 else ""),
                         lambda: K2.conv1(feats, sw["w1"], sw["b1"], "serving"),
                         lambda: K2.conv1_plain(feats, sw["w1"], sw["b1"], "serving"), 2 ** -7,
                         library_fn=lambda: F.conv2d(feats[:, None], cw1, stride=2, padding=1), work=work1)
            same = float((y1.view(torch.int16) == K2.conv1_plain(feats, sw["w1"], sw["b1"], "serving")
                           .view(torch.int16)).float().mean())
            print(f"    {same:.6f} of its outputs equal the plain version's bit for bit; exact conv1 "
                  f"{timed(lambda: K2.conv1(feats, sw['w1'], sw['b1'])):.4f} ms, serving "
                  f"{timed(lambda: K2.conv1(feats, sw['w1'], sw['b1'], 'serving')):.4f} ms (events, same call)",
                  flush=True)
            if same != 1.0:
                _fail(f"conv1 serving B={B}: {same} of its outputs bit-equal to the plain version's, not all")
            if B != 8:
                del y1, feats
                torch.cuda.empty_cache()
                continue
            rows2 = B * T_pad * (cfg.num_fbanks // 4)
            work2 = (2.0 * rows2 * C * 9 * C, nbytes(y1, sw["w2"], sw["b2"]) + 2 * rows2 * C, "bf16")
            cw2 = sw["w2"].reshape(3, 3, C, C).permute(3, 2, 0, 1).contiguous()
            y1_nchw = y1.permute(0, 3, 1, 2)
            compare("conv2 serving", "conv2_serving", lambda: K2.conv2(y1, sw["w2"], sw["b2"], T_pad, "serving"),
                    lambda: K2.conv2_plain(y1, sw["w2"], sw["b2"], T_pad, "serving"), 2 ** -6,
                    library_fn=lambda: F.conv2d(y1_nchw, cw2, stride=2, padding=1), work=work2)
            print(f"    exact conv2 {timed(lambda: K2.conv2(y1, sw['w2'], sw['b2'], T_pad)):.4f} ms, serving "
                  f"{timed(lambda: K2.conv2(y1, sw['w2'], sw['b2'], T_pad, 'serving')):.4f} ms", flush=True)
            hidden = K2.conv_subsample(feats, sw, cfg, T_pad, "serving")
            enc = torch.clamp(feat_extract_output_frames(cfg, feat_lens.long()), 0, T).int()
            mask = torch.arange(T_pad, device=dev)[None, :] < enc[:, None]
            x = torch.where(mask[..., None], hidden, 0.0).to(torch.bfloat16).contiguous()
            M = B * T_pad
            xf = x.view(M, D)
            I = w["ff1_wi"].shape[1]
            eps = cfg.layer_norm_eps
            # the serving GELU as the layer runs it, in the GEMM with the LayerNorm
            # prologue; and without the LayerNorm (no call of the path runs that form now)
            for Mr, a in ((M, xf), (32768, torch.randn(32768, D, generator=torch.Generator().manual_seed(4))
                                    .bfloat16().to(dev))):
                key = "gemm_gelu_serving" + ("_m32768" if Mr == 32768 else "")
                ln_args = (a, w["ff1_ln_g"], w["ff1_ln_b"], eps, w["ff1_wi"], w["ff1_bi"])
                ln_gemm_hold(f"ln_gemm ff1_in serving GELU M={Mr}", key, *ln_args, timing=False, act="gelu_serving")
                g = K1.layer_norm(a, w["ff1_ln_g"], w["ff1_ln_b"], eps)
                compare(f"gemm ff1_in serving GELU M={Mr}", None,
                        lambda: K1.gemm(g, w["ff1_wi"], w["ff1_bi"], act="gelu_serving"),
                        lambda: K1.gemm_plain(g, w["ff1_wi"], w["ff1_bi"], act="gelu_serving"), 2 ** -6)
                print(f"    device ms under the profiler: with the LayerNorm prologue, serving GELU "
                      f"{device_ms(lambda: K1.ln_gemm(*ln_args, act='gelu_serving')):.4f}, exact GELU "
                      f"{device_ms(lambda: K1.ln_gemm(*ln_args, act='gelu')):.4f}", flush=True)
            qkv, q_v = K1.ln_gemm(xf, w["attn_ln_g"], w["attn_ln_b"], eps, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
            tables = fused.tables(T_pad)
            q_rot = K1.pos_query(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T_pad)
            dh = D // H
            hv = lambda i: qkv[:, i * D:(i + 1) * D].view(B, T_pad, H, dh)  # noqa: E731
            att = (hv(0), hv(1), hv(2), q_rot.view(B, T_pad, H, D), tables["k_std"], enc)
            keys = torch.where(enc > 0, enc, T_pad).sum().item()
            compare("rel_attention serving", "rel_attention_serving",
                    lambda: K1.rel_attention(*att, profile="serving"),
                    lambda: K1.rel_attention_plain(*att, profile="serving"), 2 ** -6,
                    library_fn=sdpa_call(hv(0), att[3], hv(1), hv(2), tables["k_std"], enc, 1.0)[0],
                    work=(2.0 * H * T_pad * keys * (dh + D + dh), nbytes(att[3], tables["k_std"]) + 4 * 2 * M * D,
                          "bf16"))
            print(f"    device ms under the profiler: serving {device_ms(lambda: K1.rel_attention(*att, profile='serving')):.4f}, "
                  f"exact {device_ms(lambda: K1.rel_attention(*att)):.4f}", flush=True)
            # the layer's 14 launches at these shapes, as the exact layer's row counts them
            Cg, Kc, Km = w["cg_w1"].shape[1] // 2, w["csgu_dw"].shape[0], w["merge_dw"].shape[0]
            layer_pieces = layer_work(
                M, D, I, Cg, (8.0 * M * D, 4 * M * D, "fp32"),
                (2.0 * M * D * D + 6.0 * M * H * D,
                 nbytes(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"]) + 2 * M * H * D, "bf16"),
                (2.0 * H * T_pad * keys * (dh + D + dh), nbytes(att[3], tables["k_std"]) + 4 * 2 * M * D, "bf16"),
                (2.0 * M * Cg * Kc + 10.0 * M * Cg, 4 * M * Cg + nbytes(w["csgu_dw"]) + 2 * M * Cg, "fp32"),
                (2.0 * M * 2 * D * Km, 8 * M * D + nbytes(w["merge_dw"]), "fp32"))
            compare("layer serving (K1 whole)", None,
                    lambda: K1.ebranchformer_layer(x, enc, w, cfg, T, tables, "serving"),
                    lambda: K1.ebranchformer_layer_plain(x, enc, w, cfg, T, tables, "serving"), 0.05,
                    work=layer_pieces)
            del y1, feats, hidden, x
    _build.reset_launch_counts()
    K3.MelFrontEnd(dataclasses.replace(base, matmul_precision="high"), device=dev)(wav8, lens8)
    torch.cuda.synchronize()
    high_launches = dict(_build.LAUNCHES)
    print(f"  MelFrontEnd(matmul_precision='high') on B=8: launches {high_launches}", flush=True)
    del wav_big
    torch.cuda.empty_cache()

    # ---- (c) the flagship requests through ASRPipeline in both profiles, each
    # against the plain path of its own profile
    print("-- serving (c): the flagship requests through ASRPipeline, numeric_profile 'exact' and 'serving'", flush=True)
    launches = {}
    for profile in ("exact", "serving"):
        pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=IdsRecorder(),
                           numeric_profile=profile)
        if not pipe._use_fused or pipe.numeric_profile != profile:
            _fail(f"numeric_profile {profile!r}: the pipeline did not take the fused route in that profile")
        pipe(next(iter(requests.values()))[:1])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for name, audios in requests.items():
            t = time.perf_counter()
            texts = pipe(audios)
            torch.cuda.synchronize()
            print(f"  {profile} request {name}: {(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
            if len(texts) != len(audios):
                _fail(f"{profile} {name}: {len(texts)} transcripts for {len(audios)} utterances")
        launches[profile] = dict(_build.LAUNCHES)
        print(f"  launches, {profile}: {launches[profile]}", flush=True)
        mine, other = (SERVING_KERNELS, EXACT_KERNELS) if profile == "serving" else (EXACT_KERNELS, SERVING_KERNELS)
        if any(launches[profile].get(k, 0) <= 0 for k in mine) or any(k in launches[profile] for k in other):
            _fail(f"numeric_profile {profile!r}: launches {launches[profile]}, want every one of {mine}, none of {other}")
        n_frames, n_agree = against_plain_path(pipe, requests)
        print(f"  {profile}: greedy ids agree with the plain path on {n_agree}/{n_frames} valid frames", flush=True)
        if n_agree < 0.98 * n_frames:
            _fail(f"{profile}: greedy ids agree on {n_agree}/{n_frames} valid frames, below 98 %")
        del pipe
    torch.cuda.empty_cache()

    # ---- (d) the transcript gate: the committed gate model's 64 test utterances in
    # requests of 16 through ASRPipeline(model_type="ctc"), against the JAX serving
    # composition's ids (jax_reference.json "serving"), ties by the triage rule
    with open(os.path.join(ROOT, GATE_DIR, "jax_reference.json")) as f:
        ref = json.load(f)
    rows = corpus_rows(n_train=512, n_eval=64, seed=0)["test"]
    counts = {}
    for profile, key in (("serving", "serving"), ("exact", "bfloat16")):
        rec = IdsRecorder()
        pipe = ASRPipeline(os.path.join(ROOT, GATE_DIR), model_type="ctc", device="cuda", tokenizer=rec,
                           numeric_profile=profile)
        if not pipe._use_fused:
            _fail("the gate model did not take the fused route")
        gaps, gate_launches = [], {}
        for start in range(0, 64, 16):
            audios = [np.asarray(a, np.float32) for a in rows["audio"][start:start + 16]]
            _, got_l = count_launches(lambda: pipe(audios), gate_launches)
            got = rec.ids[start:start + 16]
            differ = [b for b in range(16) if got[b] != ref[key]["ids"][start + b]]
            if differ:
                wav = torch.from_numpy(pipe._bucket_pad(audios)).to(dev)
                lens_ = torch.tensor([len(a) for a in audios], dtype=torch.int32, device=dev)
                with torch.inference_mode():
                    out = ctc_infer(pipe._fused, *pipe._frontend(wav, lens_))
                logits = out.logits.float().cpu().numpy()
                for b in differ:
                    T_ = int(out.logit_lengths[b])
                    pf, jf = logits[b, :T_].argmax(-1), np.asarray(ref[key]["frame_ids"][start + b])
                    t = int(np.flatnonzero(pf != jf)[0]) if len(jf) == T_ and (pf != jf).any() else 0
                    top2 = np.sort(logits[b, t])[-2:]
                    gaps.append((start + b, t, float(top2[1] - top2[0]), float(np.abs(logits[b, :T_]).max())))
        counts[profile] = 64 - len(gaps)
        print(f"  gate model through ASRPipeline, numeric_profile {profile!r}: {counts[profile]}/64 id sequences "
              f"equal to JAX's {key} ids; launches {gate_launches}" + "".join(
                  f"; utterance {u} frame {t}: top-two gap {g:.5f} of scale {s:.3f} (bound {TIE * s:.5f})"
                  for u, t, g, s in gaps), flush=True)
        if profile == "serving":
            if any(gate_launches.get(k, 0) <= 0 for k in ("asr_log_mel_bf16", "asr_rel_attention_serving")):
                _fail(f"gate model, serving: the serving kernels did not launch: {gate_launches}")
            for u, t, g, s in gaps:
                if g > TIE * s:
                    _fail(f"gate model, serving: utterance {u} differs from JAX at frame {t} beyond a tie")
        del pipe
    print(f"gate serving: {counts['serving']}/64 equal to JAX's serving ids", flush=True)
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches["serving"], high_launches, counts


# The bin counts past the shipped 80: Kaldi's compute-fbank-feats default
# (no multiple of 8) and Whisper large-v3's front end; the all-zero filter of
# each bank (reference caveat (k)).
MEL_BINS = (23, 128)
EMPTY_FILTER = {128: 3}
# The counts whose Kaldi bank has a filter over more than two passes of 64
# bins (all of 1-11 but 8), which the bf16 kernel sums in segments with carry
# slots; the flagship is served at WIDE_SERVED of them.
WIDE_BINS, WIDE_SERVED = tuple(range(1, 12)), 10


def mel_bins_phase(dev, smi, compare, B_big: int = 128, S: int = 160000) -> dict:
    """K3 at 23 and 128 mel bins, and its bf16 kernel at 1-11 (step 20 of the
    module's docstring). Returns the kernel rows' launch counts, {row key:
    (counter, launches)}."""
    import torch

    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    t_phase = time.perf_counter()
    gen = np.random.default_rng(21)
    wavs = np.zeros((B_big, S), np.float32)
    lens = [int(S * (1.0 - 0.005 * (i % 16))) for i in range(B_big)]
    for i in range(B_big):
        wv = speech(lens[i] / 16000, gen)
        wavs[i, :len(wv)] = wv
    wav_big = torch.from_numpy(wavs).to(dev)
    lens_big = torch.tensor(lens, dtype=torch.int32, device=dev)
    del wavs
    requests = {
        "1 utt (4 s)": [speech(4.0, gen)],
        "4 utts (6-18 s)": [speech(s_, gen) for s_ in (6.0, 9.5, 13.0, 18.0)],
        "8 utts (3-10 s)": [speech(3.0 + s_, gen) for s_ in np.linspace(0, 7, 8)],
        "8 utts (9.3-10 s)": [speech(10.0 * (1.0 - 0.01 * i), gen) for i in range(8)],
    }
    launches = {}

    def served(n_mel, empty):
        """(b): the flagship at n_mel bins, seeded weights, through ASRPipeline
        in both profiles: K3 (log-mel + CMVN) and 12 x K1, no K2 (80 bins
        only), each request held against the plain path under the caveat (k)
        rule."""
        print(f"-- mel bins (b): the flagship at {n_mel} mel bins through ASRPipeline, 'exact' and 'serving'",
              flush=True)
        cfg = flagship_config(num_fbanks=n_mel)
        model_dir = os.path.join(ROOT, "build", f"chip_smoke_model_m{n_mel}")
        save_params(seeded_model(cfg, seed=n_mel), model_dir)
        n_l = cfg.num_hidden_layers
        for profile, mel_counter, att in (("exact", "asr_log_mel", "asr_rel_attention"),
                                          ("serving", "asr_log_mel_bf16", "asr_rel_attention_serving")):
            pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=IdsRecorder(),
                               numeric_profile=profile)
            if not pipe._use_fused or pipe._fused.subsample is not None:
                _fail(f"{n_mel} bins, {profile}: the pipeline did not take the fused route behind the model's own "
                      f"front end")
            pipe(requests["1 utt (4 s)"])  # warm-up
            torch.cuda.synchronize()
            want = {mel_counter: 1, "asr_cmvn": 1, att: n_l, "asr_pos_query": n_l, "asr_layernorm_bf16": n_l,
                    "asr_gemm_ln_bf16": (n_l if profile == "serving" else 4 * n_l), "dwconv_csgu": n_l,
                    "dwconv_merge": n_l}
            summed = launches.setdefault((n_mel, profile), {})
            for name, audios in requests.items():
                t = time.perf_counter()
                texts, got_l = count_launches(lambda: pipe(audios), summed)
                print(f"  {n_mel} bins, {profile} request {name}: {(time.perf_counter() - t) * 1e3:.1f} ms; "
                      f"launches {got_l}", flush=True)
                if len(texts) != len(audios) or any(got_l.get(k, 0) != v for k, v in want.items()) \
                        or "asr_conv1" in got_l or "asr_conv1_serving" in got_l:
                    _fail(f"{n_mel} bins, {profile}, {name}: {len(texts)} transcripts, launches {got_l}, want {want} "
                          f"and no conv1")
            ties = {}
            n_frames, n_agree = against_plain_path(pipe, requests, empty_column=empty, tie_counts=ties)
            held = n_agree + ties.get("differ_at_ties", 0)
            print(f"  {n_mel} bins, {profile}: greedy ids agree with the plain path on {n_agree}/{n_frames} compared "
                  f"valid frames, {held} with near-ties (triage rule) as ties (bar 98 %)", flush=True)
            if held < 0.98 * n_frames:
                _fail(f"{n_mel} bins, {profile}: greedy ids agree on {held}/{n_frames} valid frames with ties as "
                      f"ties, below 98 %")
            del pipe
            torch.cuda.empty_cache()

    for n_mel in MEL_BINS:
        base = LogMelConfig(num_mel_bins=n_mel)
        dft_np, mel_np = K3.folded_bases(base)
        dft32, mel32 = torch.from_numpy(dft_np).to(dev), torch.from_numpy(mel_np).to(dev)
        bf = K3.split_bases(dft_np, "bf16").to(dev)
        hop, floor, L = base.hop_length, base.mel_floor, base.frame_length
        n = int(base.num_frames(S))
        empty = EMPTY_FILTER.get(n_mel)
        keep = [c for c in range(n_mel) if c != empty]

        # ---- (a) the log-mel kernel in "highest" and "bf16" and the CMVN kernel at
        # B=8 and 128 x 10 s against their plain versions, the fp64 gates, beside the
        # cuBLAS product of the same framed operands
        print(f"-- mel bins (a): {n_mel} mel bins, the log-mel kernel ('highest', 'bf16') and cmvn, B=8 and "
              f"{B_big} x {S} samples (T_in={n}); {smi}", flush=True)
        with torch.no_grad():
            for B in (8, B_big):
                wav = wav_big[:B]
                sfx = f"_m{n_mel}" + ("_b128" if B != 8 else "")
                exact = K3.log_mel_plain(wav.double(), n, dft32.double(), mel32.double(), hop, floor)
                frames32 = wav.unfold(1, L, hop)[:, :n].contiguous()
                frames16 = frames32.to(torch.bfloat16).contiguous()
                hi_t = bf[0].t()
                a32 = (n, dft32, mel32, hop, floor)
                a16 = (n, bf, mel32, hop, floor, "bf16")
                lm = compare(f"mel {n_mel} bins B={B}", "mel" + sfx, lambda: K3.log_mel(wav, *a32),
                             lambda: K3.log_mel_plain(wav, *a32), 1e-4, library_fn=lambda: frames32 @ dft32,
                             work=mel_work(wav, n, dft32, mel32))
                lm16 = compare(f"mel bf16 {n_mel} bins B={B}", "mel_bf16" + sfx, lambda: K3.log_mel(wav, *a16),
                               lambda: K3.log_mel_plain(wav, *a16), 1e-3, library_fn=lambda: frames16 @ hi_t,
                               work=mel_bf16_work(wav, n, bf, mel32))
                errs = {}
                for mode, got, args in (("highest", lm, a32), ("bf16", lm16, a16)):
                    errs[mode] = (float((got.double() - exact).abs().max()),
                                  float((K3.log_mel_plain(wav, *args).double() - exact).abs().max()))
                print(f"    against fp64: highest kernel {errs['highest'][0]:.3e}, fp32 plain (cuBLAS) "
                      f"{errs['highest'][1]:.3e}; bf16 kernel {errs['bf16'][0]:.3e}, bf16 plain "
                      f"{errs['bf16'][1]:.3e}; device ms under the profiler: highest "
                      f"{device_ms(lambda: K3.log_mel(wav, *a32)):.4f} (cuBLAS fp32 product "
                      f"{device_ms(lambda: frames32 @ dft32):.4f}), bf16 {device_ms(lambda: K3.log_mel(wav, *a16)):.4f} "
                      f"(cuBLAS bf16 product {device_ms(lambda: frames16 @ hi_t):.4f})", flush=True)
                if not errs["highest"][0] <= 2 * errs["highest"][1]:
                    _fail(f"mel {n_mel} bins B={B}: largest log-mel error against fp64 {errs['highest'][0]:.3e}, "
                          f"past twice the fp32 plain version's {errs['highest'][1]:.3e}")
                if not errs["bf16"][0] <= 1.25 * errs["bf16"][1]:
                    _fail(f"mel bf16 {n_mel} bins B={B}: largest log-mel error against fp64 {errs['bf16'][0]:.3e}, "
                          f"past 1.25x the plain bf16 version's {errs['bf16'][1]:.3e}")
                fl = torch.clamp(base.num_frames(lens_big[:B].long()), 0, n).int()
                out = compare(f"cmvn {n_mel} bins B={B}", "cmvn" + sfx, lambda: K3.cmvn(lm, fl),
                              lambda: K3.cmvn_plain(lm, fl), 2 ** -7, columns=keep,
                              work=(8.0 * lm.numel(), nbytes(lm) + 2 * lm.numel(), "fp32"))
                print(f"    cmvn device ms under the profiler: {device_ms(lambda: K3.cmvn(lm, fl)):.4f}", flush=True)
                below = torch.arange(n, device=dev)[None, :] >= fl[:, None]
                if bool(out[below].any()):
                    _fail(f"cmvn {n_mel} bins B={B}: a row at or past its length is not zero")
                if empty is not None:
                    ref = K3.cmvn_plain(lm, fl)
                    col = lambda f: tuple(sorted(set(  # noqa: E731
                        "nan" if bool(torch.isnan(f[i, :int(fl[i]), empty].float()).all())
                        else str(torch.unique(f[i, :int(fl[i]), empty].float()).tolist()) for i in range(B))))
                    same = sum(bool(torch.equal(out[i, :int(fl[i]), empty].float().nan_to_num(7.0),
                                                ref[i, :int(fl[i]), empty].float().nan_to_num(7.0)))
                               for i in range(B))
                    print(f"    column {empty} (the empty filter): kernel writes {col(out)}, plain {col(ref)}; "
                          f"equal in {same} of {B} utterances", flush=True)
                del exact, frames16, lm, lm16, out
                torch.cuda.empty_cache()

        served(n_mel, empty)
    # ---- (c) the bf16 kernel in "bf16" and "high" at 1-11 mel bins (filters over
    # more than two passes of 64 bins: segments and carry slots), B=8 (and B=128 at
    # WIDE_SERVED) against the plain version and the fp64 gate of (a); each count's
    # MelFrontEnd once, whose launches its rows carry; then the flagship at
    # WIDE_SERVED bins through ASRPipeline as in (b)
    print(f"-- mel bins (c): the bf16 log-mel kernel ('bf16', 'high') at {WIDE_BINS[0]}-{WIDE_BINS[-1]} mel bins, "
          f"B=8 (and {B_big} at {WIDE_SERVED}) x {S} samples; {smi}", flush=True)
    t_wide = time.perf_counter()
    front_end_launches = {}
    with torch.no_grad():
        for n_mel in WIDE_BINS:
            for mode in ("bf16", "high"):
                base = LogMelConfig(num_mel_bins=n_mel, matmul_precision=mode)
                fe = K3.MelFrontEnd(base, device=dev)
                dft_np, _ = K3.folded_bases(base)
                dft64 = torch.from_numpy(dft_np).to(dev).double()
                hop, floor, L = base.hop_length, base.mel_floor, base.frame_length
                n = int(base.num_frames(S))
                hi_t = fe.dft[0].t()
                for B in ((8, B_big) if n_mel == WIDE_SERVED else (8,)):
                    wav = wav_big[:B]
                    key = f"mel_{mode}_m{n_mel}" + ("_b128" if B != 8 else "")
                    args = (n, fe.dft, fe.mel, hop, floor, mode)
                    frames16 = wav.unfold(1, L, hop)[:, :n].to(torch.bfloat16).contiguous()
                    got = compare(f"mel {mode} {n_mel} bins B={B}", key, lambda: K3.log_mel(wav, *args),
                                  lambda: K3.log_mel_plain(wav, *args), 1e-3, library_fn=lambda: frames16 @ hi_t,
                                  work=mel_bf16_work(wav, n, fe.dft, fe.mel))
                    exact = K3.log_mel_plain(wav.double(), n, dft64, fe.mel.double(), hop, floor)
                    d_k, d_p = got.double() - exact, K3.log_mel_plain(wav, *args).double() - exact
                    err_k, err_p = float(d_k.abs().max()), float(d_p.abs().max())
                    gate = 1.25  # as at 23 bins, in both modes
                    line = (f"    against fp64: kernel {err_k:.3e}, plain {err_p:.3e} ({err_k / err_p:.2f}x, gate "
                            f"{gate}x); mean error kernel {float(d_k.mean()):+.2e}, plain {float(d_p.mean()):+.2e}")
                    if n_mel == WIDE_SERVED:
                        kernel_ms = device_ms(lambda: K3.log_mel(wav, *args))
                        line += (f"; device ms under the profiler: kernel {kernel_ms:.4f}, cuBLAS bf16 product "
                                 f"{device_ms(lambda: frames16 @ hi_t):.4f}")
                    print(line, flush=True)
                    if not err_k <= gate * err_p:
                        _fail(f"mel {mode} {n_mel} bins B={B}: largest log-mel error against fp64 {err_k:.3e}, "
                              f"past {gate}x the plain version's {err_p:.3e}")
                    del got, exact, frames16, d_k, d_p
                _, front_end_launches[(n_mel, mode)] = count_launches(
                    lambda: fe(wav_big[:8], lens_big[:8]), {})
                if front_end_launches[(n_mel, mode)] != {f"asr_log_mel_{mode}": 1, "asr_cmvn": 1}:
                    _fail(f"MelFrontEnd {mode} at {n_mel} bins: launches {front_end_launches[(n_mel, mode)]}")
                del fe
    print(f"  (c) kernel holds: {time.perf_counter() - t_wide:.1f} s", flush=True)
    served(WIDE_SERVED, None)
    print(f"  (c) with the {WIDE_SERVED}-bin model: {time.perf_counter() - t_wide:.1f} s", flush=True)
    del wav_big
    torch.cuda.empty_cache()
    rows = {}
    for n_mel in MEL_BINS:
        exact_l, serving_l = launches[(n_mel, "exact")], launches[(n_mel, "serving")]
        for sfx in (f"_m{n_mel}", f"_m{n_mel}_b128"):
            rows["mel" + sfx] = ("asr_log_mel", exact_l.get("asr_log_mel", 0))
            rows["mel_bf16" + sfx] = ("asr_log_mel_bf16", serving_l.get("asr_log_mel_bf16", 0))
            rows["cmvn" + sfx] = ("asr_cmvn", exact_l.get("asr_cmvn", 0) + serving_l.get("asr_cmvn", 0))
    # the 1-11-bin rows: their MelFrontEnd call's launches, the served count's "bf16" its requests'
    for (n_mel, mode), counts in front_end_launches.items():
        counter = f"asr_log_mel_{mode}"
        if (n_mel, mode) == (WIDE_SERVED, "bf16"):
            counts = launches[(n_mel, "serving")]
        for sfx in (f"_m{n_mel}",) + ((f"_m{n_mel}_b128",) if n_mel == WIDE_SERVED else ()):
            rows[f"mel_{mode}" + sfx] = (counter, counts.get(counter, 0))
    print(f"mel bins phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    sys.path.insert(0, ROOT)
    from huggingface_asr_tpu_torch.kernels import _build
    from huggingface_asr_tpu_torch.kernels import layer as K1
    from huggingface_asr_tpu_torch.kernels import mel as K3
    from huggingface_asr_tpu_torch.kernels import subsample as K2
    from huggingface_asr_tpu_torch.kernels.attention import rel_attention, rel_attention_plain_shift
    from huggingface_asr_tpu_torch.kernels.train_attention import (
        keep_mask,
        rel_attention_train,
        rel_attention_train_plain,
    )
    from huggingface_asr_tpu_torch.data.prefetch import PrefetchIterator, pinned_device_put
    from huggingface_asr_tpu_torch.models import ebranchformer as model_module
    from huggingface_asr_tpu_torch.models.ebranchformer import feat_extract_output_frames
    from huggingface_asr_tpu_torch.models.fast_infer import FusedCTC
    from huggingface_asr_tpu_torch.ops.features import LogMelConfig
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds})", flush=True)
    log = (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill stores" in line:
            print("  ptxas:", line.strip())

    model = flagship_model(seed=0)
    cfg = model.config
    fused = FusedCTC(model, dev)
    mel_cfg = LogMelConfig(num_mel_bins=cfg.num_fbanks)
    frontend = K3.MelFrontEnd(mel_cfg, device=dev)

    results = {}
    failures = []

    def record(name, key, err, ok, ms, plain_ms, work, library_ms):
        """Print one comparison; keep, per key, the largest error over all
        its comparisons and the first one's times and bound."""
        bound_ms, bound_by = (sum_bound(work) if isinstance(work, list) else bound(*work)) if work else (None, None)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        bnd = "" if bound_ms is None else f" bound={bound_ms:.4f} ms ({bound_by})"
        print(f"  {name:28s} max_abs_err={err:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
              f"{bnd} library={lib} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        if key is not None:
            entry = results.setdefault(key, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if "ms" not in entry:
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)

    def compare(name, key, kernel_fn, plain_fn, rel_tol, iters=20, work=None, library_fn=None, columns=None):
        """Kernel vs plain on the same inputs; times are medians of 5 windows
        (``iters`` kernel calls, ``iters // 4`` plain calls each). ``work`` is
        (operations, bytes moved, type of the operations) for the bound, or a
        list of them for a chain of kernels (the sum of their bounds);
        ``library_fn`` is the one PyTorch call that computes the same function,
        timed as a yardstick and used nowhere else. The 10 s bucket runs
        first, so the JSON line carries its times. ``columns``: the last
        dimension's columns that the error reads (the rest may differ)."""
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        g = (got if isinstance(got, torch.Tensor) else got[0]).float()
        r = (ref if isinstance(ref, torch.Tensor) else ref[0]).float()
        if columns is not None:
            g, r = g[..., columns], r[..., columns]
        err = float((g - r).abs().max())
        ok = bool(torch.isfinite(g).all()) and err <= rel_tol * max(1.0, float(r.abs().max()))
        library_ms = None
        if library_fn is not None and (key is None or "ms" not in results.get(key, {})):
            with torch.no_grad():
                library_ms = timed(library_fn, iters)
        record(name, key, err, ok, timed(kernel_fn, iters), timed(plain_fn, max(2, iters // 4)),
               work, library_ms)
        return got

    def ln_gemm_hold(name, key, x, ln_g, ln_b, eps, wt, bias, timing=True, **kw):
        """The GEMM with the LayerNorm in its operand prologue against its
        plain version (2^-6 of the scale, the GEMM's; both outputs with
        ``bias2``), beside its bound and F.layer_norm + F.linear in bf16 (two
        PyTorch calls: no one call computes the pair); the share of its
        outputs bit-equal to layer_norm then gemm, the two launches it
        replaces (the kernel's contract: every one; the JSON entry keeps the
        least share as ``bit_equal_share``); with ``timing``, the device times
        of the kernel, of that chain and of the library pair. Returns the
        kernel's output."""
        M_, K_ = x.shape
        N_ = wt.shape[1]
        extra = 2 * M_ * kw["bias2"].shape[0] if "bias2" in kw else 0
        g16, b16, wt_t, bias16 = ln_g.bfloat16(), ln_b.bfloat16(), wt.t().contiguous(), bias.bfloat16()
        library = lambda: F.linear(F.layer_norm(x, (K_,), g16, b16, eps), wt_t, bias16)  # noqa: E731
        run = lambda: K1.ln_gemm(x, ln_g, ln_b, eps, wt, bias, **kw)  # noqa: E731
        plain = lambda: K1.ln_gemm_plain(x, ln_g, ln_b, eps, wt, bias, **kw)  # noqa: E731
        chain = lambda: K1.gemm(K1.layer_norm(x, ln_g, ln_b, eps), wt, bias, **kw)  # noqa: E731
        with torch.no_grad():
            got = compare(name, key, run, plain, 2 ** -6, work=ln_gemm_work(M_, K_, N_, extra), library_fn=library)
            pairs = list(zip(got, chain())) if "bias2" in kw else [(got, chain())]
            if "bias2" in kw:
                ref2 = plain()[1].float()
                if float((got[1].float() - ref2).abs().max()) > 2 ** -6 * max(1.0, float(ref2.abs().max())):
                    failures.append(f"{name}: second output")
            same = sum(int((o.view(torch.int16) == r.view(torch.int16)).sum()) for o, r in pairs) \
                / sum(o.numel() for o, _ in pairs)
            entry = results[key]
            entry["bit_equal_share"] = min(entry.get("bit_equal_share", 1.0), same)
            line = f"    bit-equal to layer_norm then gemm: {same:.6f} of its outputs"
            if timing:
                line += (f"; device ms under the profiler: kernel {device_ms(run):.4f}, layer_norm + gemm "
                         f"{device_ms(chain):.4f}, F.layer_norm + F.linear {device_ms(library):.4f}")
            print(line, flush=True)
        if same < 1.0:
            failures.append(f"{name}: {same:.6f} of its outputs bit-equal to layer_norm then gemm")
        return got

    rng = np.random.default_rng(0)
    for seconds in (10.0, 20.0):
        B = 8
        S = int(seconds * 16000)
        wavs = np.zeros((B, S), np.float32)
        lens = np.asarray([S - int(i * 0.05 * S) for i in range(B)], np.int32)
        for i in range(B):
            wavs[i, : lens[i]] = speech(lens[i] / 16000, rng)
        wav = torch.from_numpy(wavs).to(dev)
        wav_lens = torch.from_numpy(lens).to(dev)
        n_frames = int(mel_cfg.num_frames(S))
        T = int(feat_extract_output_frames(cfg, n_frames))
        T_pad = -(-T // 8) * 8
        print(f"-- B={B}, {seconds:.0f} s: T_in={n_frames}, T={T}, T_pad={T_pad}", flush=True)

        # K3
        hop, floor = mel_cfg.hop_length, mel_cfg.mel_floor
        mel_args = (n_frames, frontend.dft, frontend.mel, hop, floor)
        # The library call of the mel kernel is its plain version: the framed
        # cuBLAS fp32 products (TF32 off).
        mel_plain = lambda: K3.log_mel_plain(wav, *mel_args)  # noqa: E731
        n_mel = mel_cfg.num_mel_bins
        lm = compare("mel", "mel", lambda: K3.log_mel(wav, *mel_args), mel_plain, 1e-4, library_fn=mel_plain,
                     work=mel_work(wav, n_frames, frontend.dft, frontend.mel))
        feat_lens = torch.clamp(mel_cfg.num_frames(wav_lens.long()), 0, n_frames).int()
        feats = compare("cmvn", "cmvn", lambda: K3.cmvn(lm, feat_lens), lambda: K3.cmvn_plain(lm, feat_lens),
                        2 ** -7, work=(8.0 * lm.numel(), nbytes(lm) + 2 * lm.numel(), "fp32"))

        # K2
        sw = fused.subsample
        # library calls: F.conv2d in bf16 with the model's own conv weights
        # (conv1 on the features as one input channel, conv2 on conv1's
        # channels-last output), without the bias, GELU and re-layout that
        # the kernels fuse
        convs = [blk[0].conv for blk in model.wav2vec2.feature_extractor.conv]
        cw = [c.weight.detach().to(dev, torch.bfloat16) for c in convs]
        C = cfg.conv_dim[0]
        work_conv1 = (2.0 * 9 * C * B * ((n_frames + 1) // 2) * ((n_mel + 1) // 2),
                      nbytes(feats, sw["w1"], sw["b1"]) + 2 * C * B * ((n_frames + 1) // 2) * ((n_mel + 1) // 2),
                      "bf16")
        y1 = compare("conv1", "conv1", lambda: K2.conv1(feats, sw["w1"], sw["b1"]),
                     lambda: K2.conv1_plain(feats, sw["w1"], sw["b1"]), 2 ** -7,
                     library_fn=lambda: F.conv2d(feats[:, None], cw[0], stride=2, padding=1), work=work_conv1)
        print(f"  conv1: {conv1_bit_equal(K2, feats, sw):.6f} of its outputs equal the plain version's bit for bit",
              flush=True)
        y1_nchw = y1.permute(0, 3, 1, 2)  # (B, C, T1, F1) view, channels last in memory
        rows2 = B * T_pad * ((y1.shape[2] + 1) // 2)
        work_conv2 = (2.0 * rows2 * C * 9 * C, nbytes(y1, sw["w2"], sw["b2"]) + 2 * rows2 * C, "bf16")
        y2 = compare("conv2", "conv2", lambda: K2.conv2(y1, sw["w2"], sw["b2"], T_pad),
                lambda: K2.conv2_plain(y1, sw["w2"], sw["b2"], T_pad), 2 ** -6,
                library_fn=lambda: F.conv2d(y1_nchw, cw[1], stride=2, padding=1), work=work_conv2)
        if seconds == 10.0:
            # a frame count that is no multiple of the kernel's tile (6 output frames, 120 rows)
            B3, T3 = 3, 40
            y1_3 = y1[:B3, : 2 * T3 - 1].contiguous()
            compare(f"conv2 ragged tile (T2={T3})", "conv2", lambda: K2.conv2(y1_3, sw["w2"], sw["b2"], T3),
                    lambda: K2.conv2_plain(y1_3, sw["w2"], sw["b2"], T3), 2 ** -6)
        M2, D = B * T_pad, cfg.hidden_size  # K2's pieces: conv1, conv2, out-dense, LayerNorm + projection
        hidden = compare("subsample (K2 whole)", None, lambda: K2.conv_subsample(feats, sw, cfg, T_pad),
                         lambda: K2.conv_subsample_plain(feats, sw, cfg, T_pad), 0.05,
                         work=[work_conv1, work_conv2, gemm_work(M2, sw["wout"].shape[0], D), ln_gemm_work(M2, D, D)])
        # its LayerNorm in the projection's prologue, on the out-dense's output
        h_dense = K1.gemm(y2.view(M2, -1), sw["wout"], sw["bout"], round_first=True)
        ln_gemm_hold("ln_gemm proj (round_first)", "gemm_ln_subsample", h_dense, sw["ln_g"], sw["ln_b"],
                     cfg.layer_norm_eps, sw["wproj"], sw["bproj"], timing=seconds == 10.0, round_first=True)
        del h_dense, y2

        # K1 pieces at this bucket's shapes, with the real folded weights of layer 0
        w = fused.layers[0]
        tables = fused.tables(T_pad)
        enc_lens = torch.clamp(feat_extract_output_frames(cfg, feat_lens.long()), 0, T).int()
        mask = torch.arange(T_pad, device=dev)[None, :] < enc_lens[:, None]
        x = torch.where(mask[..., None], hidden, 0.0).to(torch.bfloat16).contiguous()
        M, D, H = B * T_pad, cfg.hidden_size, cfg.num_attention_heads
        xf = x.view(M, D)
        ln_g16, ln_b16 = w["attn_ln_g"].bfloat16(), w["attn_ln_b"].bfloat16()
        g = compare("layernorm", "layernorm", lambda: K1.layer_norm(xf, w["attn_ln_g"], w["attn_ln_b"], 1e-5),
                    lambda: K1.layer_norm_plain(xf, w["attn_ln_g"], w["attn_ln_b"], 1e-5), 2 ** -7,
                    library_fn=lambda: F.layer_norm(xf, (D,), ln_g16, ln_b16, 1e-5),
                    work=(8.0 * M * D, 2 * nbytes(xf), "fp32"))
        wi_t, bi16 = w["ff1_wi"].t(), w["ff1_bi"].bfloat16()
        compare("gemm ff1_in (+gelu)", "gemm", lambda: K1.gemm(g, w["ff1_wi"], w["ff1_bi"], act="gelu"),
                lambda: K1.gemm_plain(g, w["ff1_wi"], w["ff1_bi"], act="gelu"), 2 ** -6,
                library_fn=lambda: F.linear(g, wi_t, bi16),  # F.linear in bf16, without the fused GELU
                work=(2.0 * M * D * w["ff1_wi"].shape[1],
                      nbytes(g, w["ff1_wi"], w["ff1_bi"]) + 2 * M * w["ff1_wi"].shape[1], "bf16"))
        # the four LayerNorm-fed GEMMs of the layer as the layer runs them: the
        # LayerNorm in the operand prologue (and the subsampler's projection below)
        eps = cfg.layer_norm_eps
        h = ln_gemm_hold("ln_gemm ff1_in (+gelu)", "gemm_ln", xf, w["ff1_ln_g"], w["ff1_ln_b"], eps, w["ff1_wi"],
                         w["ff1_bi"], timing=seconds == 10.0, act="gelu")
        qkv, q_v = ln_gemm_hold("ln_gemm qkv (dual bias)", "gemm_ln", xf, w["attn_ln_g"], w["attn_ln_b"], eps,
                                w["w_qkv"], w["b_qkv"], timing=seconds == 10.0, bias2=w["bq_v"])
        ln_gemm_hold("ln_gemm cg_w1 (+gelu)", "gemm_ln", xf, w["cg_ln_g"], w["cg_ln_b"], eps, w["cg_w1"],
                     w["cg_b1"], timing=seconds == 10.0, act="gelu")
        ln_gemm_hold("ln_gemm ff2_in (+gelu)", "gemm_ln", xf, w["ff2_ln_g"], w["ff2_ln_b"], eps, w["ff2_wi"],
                     w["ff2_bi"], timing=seconds == 10.0, act="gelu")
        compare("gemm ff1_out (+residual)", "gemm",
                lambda: K1.gemm(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5),
                lambda: K1.gemm_plain(h, w["ff1_wo"], w["ff1_bo"], residual=xf, alpha=0.5), 2 ** -6)
        _, q_v_g = compare("gemm qkv (dual bias)", "gemm", lambda: K1.gemm(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"]),
                           lambda: K1.gemm_plain(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"]), 2 ** -6)
        q_v_ref = K1.gemm_plain(g, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])[1]
        err_qv = float((q_v_g.float() - q_v_ref.float()).abs().max())
        print(f"  {'gemm qkv second output':28s} max_abs_err={err_qv:.3e}")
        if err_qv > 2 ** -6 * max(1.0, float(q_v_ref.float().abs().max())):
            failures.append("gemm qkv second output")
        work_pos_query = (2.0 * M * D * D + 6.0 * M * H * D,
                          nbytes(q_v, w["wp"], tables["rot_cos"], tables["rot_sin"]) + 2 * M * H * D, "bf16")
        pq_args = (q_v, w["wp"], tables["rot_cos"], tables["rot_sin"], T_pad)
        q_rot = compare("pos_query", "pos_query", lambda: K1.pos_query(*pq_args),
                        lambda: K1.pos_query_plain(*pq_args), 2 ** -7,
                        library_fn=pos_query_library(q_v, w["wp"]), work=work_pos_query)
        dh = D // H
        hv = lambda i: qkv[:, i * D:(i + 1) * D].view(B, T_pad, H, dh)
        qr = q_rot.view(B, T_pad, H, D)
        keys = torch.where(enc_lens > 0, enc_lens, T_pad).sum().item()  # key columns the lengths need
        # the layer's own column views of the projection buffer, made once:
        # the timed call is the wrapper and its kernel
        att_args = (hv(0), hv(1), hv(2), qr, tables["k_std"], enc_lens)
        work_attention = (2.0 * H * T_pad * keys * (dh + D + dh), nbytes(qr, tables["k_std"]) + 4 * 2 * M * D, "bf16")
        compare("rel_attention", "rel_attention", lambda: K1.rel_attention(*att_args),
                lambda: K1.rel_attention_plain(*att_args),
                2 ** -6, library_fn=sdpa_call(hv(0), qr, hv(1), hv(2), tables["k_std"], enc_lens, 1.0)[0],
                work=work_attention)
        l = K1.ln_gemm(xf, w["cg_ln_g"], w["cg_ln_b"], 1e-5, w["cg_w1"], w["cg_b1"], act="gelu")
        args = (w["csgu_ln_g"], w["csgu_ln_b"], w["csgu_dw"], w["csgu_dw_b"], B, T_pad, T,
                cfg.csgu_activation, 1e-5)
        # library calls: F.conv1d(groups=C) in bf16 on the (B, C, T) view, without
        # the LayerNorm and gate (CSGU) or the residual add (merge) that the kernels fuse
        Cg, Kc = l.shape[1] // 2, w["csgu_dw"].shape[0]
        gate_in = l[:, Cg:].reshape(B, T_pad, Cg).transpose(1, 2)
        dw_c = w["csgu_dw"].t().reshape(Cg, 1, Kc).contiguous()
        work_csgu = (2.0 * M * Cg * Kc + 10.0 * M * Cg, nbytes(l, w["csgu_dw"]) + 2 * M * Cg, "fp32")
        compare("dwconv csgu", "dwconv_csgu", lambda: K1.csgu(l, *args), lambda: K1.csgu_plain(l, *args), 2 ** -7,
                library_fn=lambda: F.conv1d(gate_in, dw_c, padding=(Kc - 1) // 2, groups=Cg),
                work=work_csgu)
        merged = torch.cat([xf, xf], dim=1).contiguous()
        margs = (w["merge_dw"], w["merge_dw_b"], B, T_pad, T)
        Km = w["merge_dw"].shape[0]
        merged_in = merged.reshape(B, T_pad, 2 * D).transpose(1, 2)
        dw_m = w["merge_dw"].t().reshape(2 * D, 1, Km).contiguous()
        work_merge = (2.0 * M * 2 * D * Km, 2 * nbytes(merged) + nbytes(w["merge_dw"]), "fp32")
        compare("dwconv merge", "dwconv_merge", lambda: K1.merge_conv(merged, *margs),
                lambda: K1.merge_conv_plain(merged, *margs), 2 ** -7,
                library_fn=lambda: F.conv1d(merged_in, dw_m, padding=(Km - 1) // 2, groups=2 * D),
                work=work_merge)
        I = w["ff1_wi"].shape[1]
        work_ln = (8.0 * M * D, 2 * nbytes(xf), "fp32")
        layer_pieces = layer_work(M, D, I, Cg, work_ln, work_pos_query, work_attention, work_csgu, work_merge)
        compare("layer (K1 whole)", None,
                lambda: K1.ebranchformer_layer(x, enc_lens, w, cfg, T, tables),
                lambda: K1.ebranchformer_layer_plain(x, enc_lens, w, cfg, T, tables), 0.05, work=layer_pieces)
        if seconds == 10.0:
            # the kernels' own durations, without the host's time per launch
            dev_ms = {
                "layernorm": device_ms(lambda: K1.layer_norm(xf, w["attn_ln_g"], w["attn_ln_b"], 1e-5)),
                "pos_query": device_ms(lambda: K1.pos_query(*pq_args)),
                "mel": device_ms(lambda: K3.log_mel(wav, *mel_args)),
                "cmvn": device_ms(lambda: K3.cmvn(lm, feat_lens)),
                "conv1": device_ms(lambda: K2.conv1(feats, sw["w1"], sw["b1"])),
                "F.conv2d (conv1's library call)": device_ms(lambda: F.conv2d(feats[:, None], cw[0], stride=2,
                                                                                padding=1)),
                "dwconv_csgu": device_ms(lambda: K1.csgu(l, *args)),
                "dwconv_merge": device_ms(lambda: K1.merge_conv(merged, *margs)),
                "F.conv1d csgu": device_ms(lambda: F.conv1d(gate_in, dw_c, padding=(Kc - 1) // 2, groups=Cg)),
                "F.conv1d merge": device_ms(lambda: F.conv1d(merged_in, dw_m, padding=(Km - 1) // 2, groups=2 * D)),
                "F.layer_norm": device_ms(lambda: F.layer_norm(xf, (D,), ln_g16, ln_b16, 1e-5)),
                "torch.bmm (pos_query's library call)": device_ms(pos_query_library(q_v, w["wp"])),
                "cuBLAS fp32 log-mel (mel's library call)": device_ms(mel_plain),
            }
            print("  device ms per call under the profiler (B=8, 10 s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)

    # ---- K3's mel kernel and CMVN, K2's conv1 and K1's positional query at
    # the rows of a B=128 x 10 s request, each beside its bound and library
    # call, with device times under the profiler; and the mel kernel's
    # accuracy gate: its largest log-mel error against the folded product in
    # fp64 at most twice the fp32 plain version's (cuBLAS, TF32 off), on
    # speech-like input and on the same input x 1e-4 (bins near the mel
    # floor), at B=8 and B=128
    B_big, S10 = 128, 160000
    n10 = int(mel_cfg.num_frames(S10))
    T10 = -(-int(feat_extract_output_frames(cfg, n10)) // 8) * 8
    print(f"-- mel, cmvn, conv1 and pos_query at B={B_big} x 10 s (T_in={n10}, T_pad={T10}); the mel kernel "
          "against fp64",
          flush=True)
    gen_w = np.random.default_rng(128)
    wavs_big = np.zeros((B_big, S10), np.float32)
    for i in range(B_big):
        wv = speech(10.0 - 0.05 * (i % 16), gen_w)
        wavs_big[i, :len(wv)] = wv
    wav_big = torch.from_numpy(wavs_big).to(dev)
    del wavs_big
    with torch.no_grad():
        big_args = (n10, frontend.dft, frontend.mel, mel_cfg.hop_length, mel_cfg.mel_floor)
        big_plain = lambda: K3.log_mel_plain(wav_big, *big_args)  # noqa: E731
        compare(f"mel B={B_big}", "mel_b128", lambda: K3.log_mel(wav_big, *big_args), big_plain, 1e-4,
                library_fn=big_plain, work=mel_work(wav_big, n10, frontend.dft, frontend.mel))
        print(f"  mel B={B_big} device ms under the profiler: {device_ms(lambda: K3.log_mel(wav_big, *big_args)):.4f} "
              f"(cuBLAS fp32 log-mel {device_ms(big_plain):.4f})", flush=True)
        for name, wv_ in (("B=8 speech", wav_big[:8]), ("B=8 quiet (x 1e-4)", wav_big[:8] * 1e-4),
                          (f"B={B_big} speech", wav_big), (f"B={B_big} quiet (x 1e-4)", wav_big * 1e-4)):
            err_k, err_p = mel_errors(K3, wv_, n10, frontend, mel_cfg)
            ok = err_k <= 2 * err_p
            print(f"  mel against fp64, {name}: kernel {err_k:.3e}, fp32 plain version (cuBLAS) {err_p:.3e}, "
                  f"ratio {err_k / err_p:.3f} (at most 2) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"mel against fp64, {name}")
        # K3's CMVN and K2's conv1 on this request's log-mel (lengths of 9.25-10 s)
        lm_big = K3.log_mel(wav_big, *big_args)
        lens_big = torch.tensor([int((10.0 - 0.05 * (i % 16)) * 16000) for i in range(B_big)],  # speech()'s
                                dtype=torch.int32, device=dev)
        n_big = torch.clamp(mel_cfg.num_frames(lens_big.long()), 0, n10).int()
        feats_big = compare(f"cmvn B={B_big}", "cmvn_b128", lambda: K3.cmvn(lm_big, n_big),
                            lambda: K3.cmvn_plain(lm_big, n_big), 2 ** -7,
                            work=(8.0 * lm_big.numel(), nbytes(lm_big) + 2 * lm_big.numel(), "fp32"))
        T1_big = (n10 + 1) // 2
        compare(f"conv1 B={B_big}", "conv1_b128", lambda: K2.conv1(feats_big, sw["w1"], sw["b1"]),
                lambda: K2.conv1_plain(feats_big, sw["w1"], sw["b1"]), 2 ** -7,
                library_fn=lambda: F.conv2d(feats_big[:, None], cw[0], stride=2, padding=1),
                work=(2.0 * 9 * C * B_big * T1_big * (n_mel // 2),
                      nbytes(feats_big, sw["w1"], sw["b1"]) + 2 * C * B_big * T1_big * (n_mel // 2), "bf16"))
        print(f"  conv1 B={B_big}: {conv1_bit_equal(K2, feats_big, sw):.6f} of its outputs equal the plain "
              f"version's bit for bit", flush=True)
        print(f"  B={B_big} device ms under the profiler: cmvn {device_ms(lambda: K3.cmvn(lm_big, n_big)):.4f}, "
              f"conv1 {device_ms(lambda: K2.conv1(feats_big, sw['w1'], sw['b1'])):.4f} (F.conv2d in bf16 "
              f"{device_ms(lambda: F.conv2d(feats_big[:, None], cw[0], stride=2, padding=1)):.4f})", flush=True)
        del wav_big, big_plain, lm_big, feats_big
        torch.cuda.empty_cache()
        M_big = B_big * T10
        q_v_big = torch.randn(M_big, w["wp"].shape[0] * w["wp"].shape[2],
                              generator=torch.Generator().manual_seed(129)).bfloat16().to(dev)
        tab10 = fused.tables(T10)
        pq_big = (q_v_big, w["wp"], tab10["rot_cos"], tab10["rot_sin"], T10)
        D, H = cfg.hidden_size, cfg.num_attention_heads
        compare(f"pos_query B={B_big}", "pos_query_b128", lambda: K1.pos_query(*pq_big),
                lambda: K1.pos_query_plain(*pq_big), 2 ** -7, library_fn=pos_query_library(q_v_big, w["wp"]),
                work=(2.0 * M_big * D * D + 6.0 * M_big * H * D,
                      nbytes(q_v_big, w["wp"], tab10["rot_cos"], tab10["rot_sin"]) + 2 * M_big * H * D, "bf16"))
        print(f"  pos_query B={B_big} device ms under the profiler: {device_ms(lambda: K1.pos_query(*pq_big)):.4f} "
              f"(torch.bmm {device_ms(pos_query_library(q_v_big, w['wp'])):.4f})", flush=True)
        del q_v_big, pq_big
        torch.cuda.empty_cache()

    # ---- the fused layer's attention kernel beyond the two buckets above:
    # seeded inputs as column views of one (B*T_pad, 3D) buffer, which is how
    # the layer passes q_u, k and v
    D, H = cfg.hidden_size, cfg.num_attention_heads
    dh = D // H

    def factored_inputs(B, T_pad, lens, seed):
        g = torch.Generator().manual_seed(seed)
        mk = lambda *shape: torch.randn(*shape, generator=g).bfloat16().to(dev)  # noqa: E731
        qkv, q_rot, k_std = mk(B * T_pad, 3 * D), mk(B, T_pad, H, D) * 0.25, mk(T_pad, D)
        q_u, k, v = (qkv[:, i * D:(i + 1) * D].view(B, T_pad, H, dh) for i in range(3))
        return q_u, k, v, q_rot, k_std, torch.tensor(lens, dtype=torch.int32, device=dev)

    print("-- rel_attention on strided views: 2 s, 20 s and 30 s buckets, lengths with 0 and 1", flush=True)
    for T_pad in (56, 512, 752):
        lens = [T_pad, 1, 0, T_pad - 7, T_pad // 2, 65, 64, (3 * T_pad) // 4]
        fi = factored_inputs(8, T_pad, lens, seed=T_pad)
        compare(f"rel_attention T_pad={T_pad}", "rel_attention", lambda: K1.rel_attention(*fi),
                lambda: K1.rel_attention_plain(*fi), 2 ** -6)
    fi = factored_inputs(B_big, 256, [256 - (i * 256) // (2 * B_big) for i in range(B_big)], seed=128)
    with torch.no_grad():
        compare(f"rel_attention B={B_big} T_pad=256", None, lambda: K1.rel_attention(*fi),
                lambda: K1.rel_attention_plain(*fi), 2 ** -6,
                library_fn=sdpa_call(fi[0], fi[3], fi[1], fi[2], fi[4], fi[5], 1.0)[0],
                work=(2.0 * H * 256 * float(fi[5].sum()) * (dh + D + dh),
                      nbytes(fi[3], fi[4]) + 4 * 2 * B_big * 256 * D, "bf16"))
    del fi
    torch.cuda.empty_cache()

    # ---- the GEMM at the rows of a B=128 x 10 s request (M = 128 * 256), with
    # layer 0's folded weights and the subsampler's out-dense; then at a ragged
    # M and into each half of a wider buffer. F.linear is the library call,
    # without what the kernel's epilogue fuses.
    print(f"-- gemm at M={B_big * 256} (B={B_big}, T_pad=256), at M=56, and into column slices; the LayerNorm-fed "
          "ones with the LayerNorm in their prologue", flush=True)
    gen = torch.Generator().manual_seed(3)
    rows = lambda m, k: torch.randn(m, k, generator=gen).bfloat16().to(dev)  # noqa: E731
    I = w["ff1_wi"].shape[1]
    Cg = w["cg_w2"].shape[0]
    wout, bout = fused.subsample["wout"], fused.subsample["bout"]

    def gemm_case(name, key, M, a, wt, bias, lib=True, **kw):
        K_, N_ = wt.shape
        moved = nbytes(a, wt, bias) + 2 * M * N_ + sum(nbytes(kw[k]) for k in ("residual",) if k in kw) \
            + (2 * M * kw["bias2"].shape[0] if "bias2" in kw else 0)
        wt_t, b16 = wt.t(), bias.bfloat16()
        a_lin = a.contiguous()
        return compare(name, key, lambda: K1.gemm(a, wt, bias, **kw), lambda: K1.gemm_plain(a, wt, bias, **kw),
                       2 ** -6, work=(2.0 * M * K_ * N_, moved, "bf16"),
                       library_fn=(lambda: F.linear(a_lin, wt_t, b16)) if lib else None)

    Mb = B_big * 256
    with torch.no_grad():
        g_big, x_big = rows(Mb, D), rows(Mb, D)
        h_big = gemm_case("gemm ff1_in (+act) M=32768", "gemm_m32768_ff1_in", Mb, g_big, w["ff1_wi"], w["ff1_bi"],
                          act=cfg.hidden_act)
        gemm_case("gemm ff1_out (+res) M=32768", "gemm_m32768_ff1_out", Mb, h_big, w["ff1_wo"], w["ff1_bo"],
                  residual=x_big, alpha=0.5)
        gemm_case("gemm qkv (dual) M=32768", "gemm_m32768_qkv", Mb, g_big, w["w_qkv"], w["b_qkv"], bias2=w["bq_v"])
        merged_big = torch.full((Mb + 8, 2 * D), 7.0, dtype=torch.bfloat16, device=dev)
        gemm_case("gemm cg_w2 -> merged[:, D:]", "gemm_m32768_cg_w2", Mb, rows(Mb, Cg), w["cg_w2"], w["cg_b2"],
                  out=merged_big[:Mb, D:])
        if not bool((merged_big[:Mb, :D] == 7.0).all()) or not bool((merged_big[Mb:] == 7.0).all()):
            failures.append("gemm cg_w2: wrote outside its column slice")
        del merged_big, h_big
        gemm_case("gemm out-dense (K=5120)", "gemm_m32768_out_dense", Mb, rows(Mb, wout.shape[0]), wout, bout,
                  round_first=True)
        # the LayerNorm-fed GEMMs at these rows: the LayerNorm in the operand prologue
        for name, key, ln_key, wk, bk, kw in (
                ("ff1_in (+act)", "gemm_ln_m32768_ff1_in", "ff1", "ff1_wi", "ff1_bi", dict(act=cfg.hidden_act)),
                ("qkv (dual)", "gemm_ln_m32768_qkv", "attn", "w_qkv", "b_qkv", dict(bias2=w["bq_v"])),
                ("cg_w1 (+gelu)", "gemm_ln_m32768_cg_w1", "cg", "cg_w1", "cg_b1", dict(act="gelu"))):
            ln_gemm_hold(f"ln_gemm {name} M=32768", key, x_big, w[f"{ln_key}_ln_g"], w[f"{ln_key}_ln_b"],
                         cfg.layer_norm_eps, w[wk], w[bk], **kw)
        del g_big, x_big
        torch.cuda.empty_cache()
        # a ragged M (B=1, T_pad=56: less than one tile), every epilogue, and both halves of `merged`
        Ms = 56
        g_s, x_s = rows(Ms, D), rows(Ms, D)
        gemm_case("gemm ff1_in M=56", "gemm", Ms, g_s, w["ff1_wi"], w["ff1_bi"], lib=False, act=cfg.hidden_act)
        gemm_case("gemm ff1_out M=56", "gemm", Ms, rows(Ms, I), w["ff1_wo"], w["ff1_bo"], lib=False,
                  residual=x_s, alpha=0.5)
        gemm_case("gemm qkv M=56", "gemm", Ms, g_s, w["w_qkv"], w["b_qkv"], lib=False, bias2=w["bq_v"])
        gemm_case("gemm out-dense M=56", "gemm", Ms, rows(Ms, wout.shape[0]), wout, bout, lib=False, round_first=True)
        ln_gemm_hold("ln_gemm qkv (dual) M=56", "gemm_ln", x_s, w["attn_ln_g"], w["attn_ln_b"], cfg.layer_norm_eps,
                     w["w_qkv"], w["b_qkv"], timing=False, bias2=w["bq_v"])
        for half, (wt, bias, a_s) in enumerate(((w["wo"], w["bo"], g_s), (w["cg_w2"], w["cg_b2"], rows(Ms, Cg)))):
            merged_s = torch.full((Ms + 8, 2 * D), 7.0, dtype=torch.bfloat16, device=dev)
            gemm_case(f"gemm -> merged half {half} M=56", "gemm", Ms, a_s, wt, bias, lib=False,
                      out=merged_s[:Ms, half * D:(half + 1) * D])
            other = merged_s[:Ms, (1 - half) * D:(2 - half) * D]
            if not bool((other == 7.0).all()) or not bool((merged_s[Ms:] == 7.0).all()):
                failures.append(f"gemm into merged half {half}: wrote outside its slice")

    # ---- the depthwise convs at the rows of a B=128 x 10 s request, each beside
    # its bound and F.conv1d(groups=C); then against their plain versions at
    # t_valid off the tiles' edges, 1 and T, at K = 3, 31, 33, on a strided l,
    # and into the first rows of a larger buffer whose other rows must stay
    # untouched (T = 70 is no multiple of either tile)
    print(f"-- depthwise convs at B={B_big}, T_pad=256 and across t_valid, K, strides", flush=True)
    Cg, Kc = w["csgu_dw"].shape[1], w["csgu_dw"].shape[0]
    Cm = 2 * D

    def dw_inputs(mode, B, T, K, seed, lead=0):
        gen = torch.Generator().manual_seed(seed)
        C = Cg if mode == 0 else Cm
        width = 2 * C if mode == 0 else C
        x_ = torch.randn(B * T, width + 2 * lead, generator=gen).bfloat16().to(dev)[:, lead:lead + width]
        if K == Kc:  # the model's own weights
            key = "csgu_dw" if mode == 0 else "merge_dw"
            return x_, w[key], w[key + "_b"]
        return (x_, (torch.randn(K, C, generator=gen) * K ** -0.5).bfloat16().to(dev),
                (torch.randn(C, generator=gen) * 0.1).to(dev))

    def dw_call(mode, x_, wk, bk, B, T, t_valid, out=None):
        if mode == 0:
            return K1._dwconv(0, x_, w["csgu_ln_g"], w["csgu_ln_b"], wk, bk, B, T, t_valid,
                              cfg.csgu_activation, 1e-5, "dwconv_csgu", out=out)
        return K1._dwconv(1, x_, None, None, wk, bk, B, T, t_valid, "identity", 0.0, "dwconv_merge", out=out)

    def dw_plain(mode, x_, wk, bk, B, T, t_valid):
        if mode == 0:
            return K1.csgu_plain(x_, w["csgu_ln_g"], w["csgu_ln_b"], wk, bk, B, T, t_valid,
                                 cfg.csgu_activation, 1e-5)
        return K1.merge_conv_plain(x_, wk, bk, B, T, t_valid)

    with torch.no_grad():
        for mode, name in ((0, "csgu"), (1, "merge")):
            x_, wk, bk = dw_inputs(mode, B_big, 256, Kc, seed=11 + mode)
            C = Cg if mode == 0 else Cm
            lib_in = x_[:, C:] if mode == 0 else x_
            lib_in = lib_in.reshape(B_big, 256, C).transpose(1, 2)
            lib_w = wk.t().reshape(C, 1, Kc).contiguous()
            moved = (nbytes(x_, wk) + 2 * B_big * 256 * C) if mode == 0 else (2 * nbytes(x_) + nbytes(wk))
            compare(f"dwconv {name} B={B_big} T_pad=256", f"dwconv_{name}_b{B_big}",
                    lambda: dw_call(mode, x_, wk, bk, B_big, 256, 250),
                    lambda: dw_plain(mode, x_, wk, bk, B_big, 256, 250), 2 ** -7,
                    library_fn=lambda: F.conv1d(lib_in, lib_w, padding=(Kc - 1) // 2, groups=C),
                    work=(2.0 * B_big * 256 * C * Kc + (10.0 * B_big * 256 * C if mode == 0 else 0.0), moved,
                          "fp32"))
            print(f"  dwconv {name} B={B_big} T_pad=256 device ms under the profiler: "
                  f"{device_ms(lambda: dw_call(mode, x_, wk, bk, B_big, 256, 250)):.4f} "
                  f"(F.conv1d {device_ms(lambda: F.conv1d(lib_in, lib_w, padding=(Kc - 1) // 2, groups=C)):.4f})",
                  flush=True)
            del x_, lib_in
            torch.cuda.empty_cache()
            errs = []
            for (B_, T_), K_, tv in itertools.product(((8, 256), (B_big, 256), (3, 70)), (3, Kc, 33),
                                                       ("ragged", 1, "T")):
                t_valid = {"ragged": T_ - 5, "T": T_}.get(tv, tv)
                x_, wk, bk = dw_inputs(mode, B_, T_, K_, seed=B_ + T_ + K_)
                got, ref = dw_call(mode, x_, wk, bk, B_, T_, t_valid), dw_plain(mode, x_, wk, bk, B_, T_, t_valid)
                err = float((got.float() - ref.float()).abs().max())
                errs.append(err)
                scale = max(1.0, float(ref.float().abs().max()))
                if not bool(torch.isfinite(got.float()).all()) or err > 2 ** -7 * scale:
                    failures.append(f"dwconv {name} B={B_} T={T_} K={K_} t_valid={t_valid}")
            x_, wk, bk = dw_inputs(mode, B_big, 256, Kc, seed=5, lead=64)  # a row view of a wider buffer
            got, ref = dw_call(mode, x_, wk, bk, B_big, 256, 251), dw_plain(mode, x_, wk, bk, B_big, 256, 251)
            err = float((got.float() - ref.float()).abs().max())
            errs.append(err)
            if err > 2 ** -7 * max(1.0, float(ref.float().abs().max())) \
                    or not torch.equal(got, dw_call(mode, x_.contiguous(), wk, bk, B_big, 256, 251)):
                failures.append(f"dwconv {name} on a strided input")
            for B_, T_ in ((3, 70), (B_big, 256)):
                x_, wk, bk = dw_inputs(mode, B_, T_, Kc, seed=7)
                guard = torch.full((B_ * T_ + 80, C), 7.0, dtype=torch.bfloat16, device=dev)
                got = dw_call(mode, x_, wk, bk, B_, T_, T_ - 9, out=guard[:B_ * T_])
                ref = dw_plain(mode, x_, wk, bk, B_, T_, T_ - 9)
                errs.append(float((got.float() - ref.float()).abs().max()))
                if not bool((guard[B_ * T_:] == 7.0).all()):
                    failures.append(f"dwconv {name} wrote past the last row (B={B_}, T={T_})")
            results[f"dwconv_{name}"]["max_abs_err"] = max(results[f"dwconv_{name}"]["max_abs_err"], *errs)
            print(f"  dwconv {name}: B in (8, {B_big}, 3) x K in (3, {Kc}, 33) x t_valid in (T-5, 1, T), a strided "
                  f"input, rows past the last untouched: max_abs_err={max(errs):.3e}", flush=True)
        torch.cuda.empty_cache()

    fi = factored_inputs(1, 64, [64], seed=1)
    g = torch.Generator().manual_seed(2)
    si = [torch.randn(1, 64, H, dh, generator=g).bfloat16().to(dev) for _ in range(4)]
    si += [torch.randn(127, H, dh, generator=g).bfloat16().to(dev), fi[5]]
    print(f"host time per launch (B=1, T=64): rel_attention {host_us_per_launch(lambda: K1.rel_attention(*fi)):.2f} us, "
          f"shift attention {host_us_per_launch(lambda: rel_attention(*si)):.2f} us, "
          f"layernorm {host_us_per_launch(lambda: K1.layer_norm(xf[:64], w['attn_ln_g'], w['attn_ln_b'], 1e-5)):.2f} us, "
          f"gemm {host_us_per_launch(lambda: K1.gemm(xf[:64], w['ff1_wi'], w['ff1_bi'], act='gelu')):.2f} us",
          flush=True)

    # ---- the main path: ASRPipeline on the card
    model_dir = os.path.join(ROOT, "build", "chip_smoke_model")
    save_params(model, model_dir)

    class PieceTable:
        """id -> piece decoding for the random model's 500 outputs."""

        def decode(self, ids, skip_special_tokens=True):
            return "".join(chr(ord("a") + i % 26) if i % 7 else " " for i in ids)

    pipe = ASRPipeline(model_dir, model_type="ctc", device="cuda", tokenizer=PieceTable(), numeric_profile="exact")
    if not pipe._use_fused:
        _fail("pipeline did not select the fused kernel path")
    requests = {
        "1 utt (4 s)": [speech(4.0, rng)],
        "4 utts (6-18 s)": [speech(s, rng) for s in (6.0, 9.5, 13.0, 18.0)],
        "8 utts (3-10 s)": [speech(3.0 + s, rng) for s in np.linspace(0, 7, 8)],
    }
    pipe(requests["1 utt (4 s)"])  # first call: warm the allocator
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for name, audios in requests.items():
        t = time.perf_counter()
        texts = pipe(audios)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if len(texts) != len(audios):
            _fail(f"{name}: {len(texts)} transcripts for {len(audios)} utterances")
        print(f"request {name}: {ms:.1f} ms; transcripts: {[s[:40] for s in texts]}", flush=True)
    launches = dict(_build.LAUNCHES)
    print(f"launches in the pipeline phase: {launches}", flush=True)
    needed = ["asr_log_mel", "asr_cmvn", "asr_conv1", "asr_conv2", "asr_gemm_bf16", "asr_gemm_ln_bf16",
              "asr_layernorm_bf16", "asr_pos_query", "asr_rel_attention", "dwconv_csgu",
              "dwconv_merge"]
    missing = [k for k in needed if launches.get(k, 0) <= 0]
    if missing:
        _fail(f"kernels not launched on the main path: {missing}")
    # the standalone LayerNorms of one flagship request: each layer's final one
    # (with the LayerNorm apart from its GEMM: 5 a layer and the subsampler's)
    _, one = count_launches(lambda: pipe(requests["8 utts (3-10 s)"]), {})
    n_l = cfg.num_hidden_layers
    want_ln = {"asr_layernorm_bf16": n_l, "asr_gemm_ln_bf16": 4 * n_l + 1}
    print(f"a flagship request (8 utts): {one.get('asr_layernorm_bf16', 0)} standalone LayerNorm launches (the "
          f"LayerNorm apart from its GEMM: {5 * n_l + 1}), {one.get('asr_gemm_ln_bf16', 0)} GEMMs with the LayerNorm "
          f"prologue, {sum(one.values())} kernel launches", flush=True)
    if any(one.get(k, 0) != v for k, v in want_ln.items()):
        _fail(f"a flagship request launched {one}, want {want_ln}")

    # Every request of the main path; pooled over them, the greedy ids must
    # also agree on >= 98 % of all valid frames (random weights leave many
    # near-ties).
    n_frames, n_agree = against_plain_path(pipe, requests)
    if n_agree < 0.98 * n_frames:
        _fail(f"greedy ids agree on {n_agree}/{n_frames} valid frames, below 98 %")

    # ---- K4 (training attention) and K5 (shift-form inference attention)
    # against their plain versions. fp32: the kernel's FMA loops and the plain
    # matmuls (TF32 off) sum in another order, 1e-4 of each tensor's scale.
    # bf16: both sides round P, the dropped P and dS to bf16 at the same
    # points and differ where an fp32 value lands on the other side of a
    # rounding boundary, 2^-6 of each tensor's scale. The keep-mask is the
    # same function on both sides (checked bit for bit below), so the
    # tolerance at rate 0.1 is the tolerance at rate 0.
    att_tol = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
    H, dh, D = cfg.num_attention_heads, cfg.head_size, cfg.hidden_size
    scale = 1.0 / float(np.sqrt(dh))

    def attention_inputs(B, T, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        mk = lambda *shape: torch.randn(*shape, generator=g).to(dtype).to(dev)  # noqa: E731
        t = dict(q_u=mk(B, T, H, dh), q_rot=mk(B, T, H, D) * 0.25, k=mk(B, T, H, dh), v=mk(B, T, H, dh),
                 k_std=mk(T, D), q_v=mk(B, T, H, dh), pos=mk(2 * T - 1, H, dh), cot=mk(B, T, H, dh))
        lens = [T - (i * T) // (2 * B) for i in range(B)]
        lens[B // 2] = 0  # one zero-length row
        t["lengths"] = torch.tensor(lens, dtype=torch.int32, device=dev)
        return t

    def train_attention_run(fn, t, seed, rate):
        leaves = [t[n].clone().requires_grad_(True) for n in ("q_u", "q_rot", "k", "v")]
        out = fn(*leaves, t["k_std"], t["lengths"], seed, rate)
        return [out.detach()] + list(torch.autograd.grad(out, leaves, t["cot"]))

    def worst(got, ref, tol):
        """(largest abs error over the tensors, all within tol of their scale)."""
        errs, ok = [], True
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            err = float((g - r).abs().max())
            ok = ok and bool(torch.isfinite(g).all()) and err <= tol * max(1.0, float(r.abs().max()))
            errs.append(err)
        return max(errs), ok

    print("-- training attention (K4) and shift-form attention (K5) vs plain, B=8", flush=True)
    for T in (250, 500):
        for dtype in (torch.bfloat16, torch.float32):
            t = attention_inputs(8, T, dtype, seed=T)
            for rate in (0.0, 0.1):
                got = train_attention_run(rel_attention_train, t, 77, rate)
                ref = train_attention_run(rel_attention_train_plain, t, 77, rate)
                torch.cuda.synchronize()
                tag = f"T={T} {str(dtype).split('.')[-1]} rate={rate}"
                for part, sl in (("fwd", slice(0, 1)), ("bwd (4 gradients)", slice(1, 5))):
                    err, ok = worst(got[sl], ref[sl], att_tol[dtype])
                    print(f"  K4 {part:18s} {tag:28s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        failures.append(f"K4 {part} {tag}")
            args = (t["q_u"], t["q_v"], t["k"], t["v"], t["pos"], t["lengths"])
            err, ok = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[dtype])
            print(f"  K5 {'fwd':18s} T={T} {str(dtype).split('.')[-1]:20s} max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K5 T={T} {dtype}")

    # A sequence length that is no multiple of the 64-key tile, with rows of
    # length 1 and 0 (bf16: the forward on wgmma, the backward fed by its stats).
    t = attention_inputs(4, 333, torch.bfloat16, seed=333)
    t["lengths"] = torch.tensor([333, 1, 0, 200], dtype=torch.int32, device=dev)
    got = train_attention_run(rel_attention_train, t, 77, 0.1)
    ref = train_attention_run(rel_attention_train_plain, t, 77, 0.1)
    for part, sl in (("fwd", slice(0, 1)), ("bwd (4 gradients)", slice(1, 5))):
        err, ok = worst(got[sl], ref[sl], att_tol[torch.bfloat16])
        print(f"  K4 {part:18s} {'T=333 lengths 333,1,0,200':28s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"K4 {part} T=333")
    # K5 on the same ragged rows, and at T=70: one ragged key tile, whose band
    # takes in table rows below 0 and past 2T - 2
    for tag, tt in (("T=333 lengths 333,1,0,200", t), ("T=70 lengths 70,33,0", attention_inputs(3, 70, torch.bfloat16, seed=70))):
        if tag.startswith("T=70"):
            tt["lengths"] = torch.tensor([70, 33, 0], dtype=torch.int32, device=dev)
        args = (tt["q_u"], tt["q_v"], tt["k"], tt["v"], tt["pos"], tt["lengths"])
        err, ok = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[torch.bfloat16])
        print(f"  K5 {'fwd':18s} {tag:28s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"K5 {tag}")

    # The backward at the narrower widths the kernels take (q_rot and k_std in
    # one and two 64-column chunks), a ragged single tile and the training length.
    def narrow_inputs(B, T, Hn, Dn, seed):
        g = torch.Generator().manual_seed(seed)
        mk = lambda *shape: torch.randn(*shape, generator=g).bfloat16().to(dev)  # noqa: E731
        return dict(q_u=mk(B, T, Hn, dh), q_rot=mk(B, T, Hn, Dn) * 0.25, k=mk(B, T, Hn, dh), v=mk(B, T, Hn, dh),
                    k_std=mk(T, Dn), cot=mk(B, T, Hn, dh),
                    lengths=torch.tensor([T, 1, 0, (2 * T) // 3][:B], dtype=torch.int32, device=dev))

    for Dn in (64, 128):
        for B, T in ((3, 70), (4, 250)):
            t = narrow_inputs(B, T, Dn // dh, Dn, seed=Dn + T)
            got = train_attention_run(rel_attention_train, t, 77, 0.1)
            ref = train_attention_run(rel_attention_train_plain, t, 77, 0.1)
            err, ok = worst(got[1:], ref[1:], att_tol[torch.bfloat16])
            print(f"  K4 {'bwd (4 gradients)':18s} {f'D={Dn} T={T} lengths T,1,0,..':28s} max_abs_err={err:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K4 bwd D={Dn} T={T}")

    def kernel_keep_mask(B_, T_, H_, dh_, D_, dtype, row0):
        """Whether K4's keep-mask, read out of the kernel itself, is the plain
        version's (printed): with zero queries every valid key has the same
        probability, and v = one-hot of (s mod dh_) within one dh_-key chunk
        makes out[t, d] non-zero exactly where key dh_*chunk + d was kept."""
        g = torch.Generator().manual_seed(5)
        k_ = torch.randn(B_, T_, H_, dh_, generator=g).to(dtype).to(dev)
        k_std_ = torch.randn(T_, D_, generator=g).to(dtype).to(dev)
        lengths_ = torch.full((B_,), T_, dtype=torch.int32, device=dev)
        zq, zr = torch.zeros_like(k_), torch.zeros(B_, T_, H_, D_, dtype=dtype, device=dev)
        kept = torch.zeros(B_, H_, T_, T_, dtype=torch.bool, device=dev)
        with torch.no_grad():
            for c0 in range(0, T_, dh_):
                probe = torch.zeros_like(k_)
                for d in range(min(dh_, T_ - c0)):
                    probe[:, c0 + d, :, d] = 1.0
                out = rel_attention_train(zq, zr, k_, probe, k_std_, lengths_, 4242, 0.1, row0=row0)
                kept[:, :, :, c0:c0 + dh_] = (out != 0).permute(0, 2, 1, 3)[..., : min(dh_, T_ - c0)]
        same = bool(torch.equal(kept, keep_mask(4242, B_, H_, T_, 0.1, dev, row0=row0)))
        print(f"  K4 keep-mask ({str(dtype).split('.')[-1]}, dh {dh_}, q_rot {D_}, rows numbered from {row0}) read "
              f"from the kernel equals the plain version's: {same} (kept share {float(kept.float().mean()):.4f})",
              flush=True)
        return same

    for row0 in (0, 3):  # 3: a data-parallel rank's first row of the global batch
        if not kernel_keep_mask(4, 250, H, dh, D, torch.bfloat16, row0):
            failures.append(f"K4 keep-mask, row0 {row0}")

    # At the training path's own shape, B=32, T=250, bf16, rate 0.1: each
    # kernel against its plain version (same tolerance), then the times (the
    # library call runs at rate 0). These are the JSON line's numbers.
    print("-- attention kernels at the training path's shape: B=32, T=250, bf16, rate 0.1", flush=True)
    Bt, Tt = 32, 250
    t = attention_inputs(Bt, Tt, torch.bfloat16, seed=1)
    got = train_attention_run(rel_attention_train, t, 77, 0.1)
    ref = train_attention_run(rel_attention_train_plain, t, 77, 0.1)
    (err_fwd, ok_fwd), (err_bwd, ok_bwd) = (worst(got[sl], ref[sl], att_tol[torch.bfloat16])
                                            for sl in (slice(0, 1), slice(1, 5)))
    args = (t["q_u"], t["q_v"], t["k"], t["v"], t["pos"], t["lengths"])
    err_k5, ok_k5 = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[torch.bfloat16])
    del got, ref
    keys = float(torch.where(t["lengths"] > 0, t["lengths"], Tt).sum())
    small, big = nbytes(t["q_u"]), nbytes(t["q_rot"])
    lib_fwd, lib_make_bwd = sdpa_call(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], t["lengths"], scale)

    def backward_call(fn):
        leaves = [t[n].clone().requires_grad_(True) for n in ("q_u", "q_rot", "k", "v")]
        out = fn(*leaves, t["k_std"], t["lengths"], 77, 0.1)
        return lambda: torch.autograd.grad(out, leaves, t["cot"], retain_graph=True)

    with torch.no_grad():
        fwd = lambda fn: (lambda: fn(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], t["lengths"], 77, 0.1))  # noqa: E731
        record("K4 fwd", "rel_attention_train_fwd", err_fwd, ok_fwd,
               timed(fwd(rel_attention_train), 20), timed(fwd(rel_attention_train_plain), 5),
               (2.0 * H * Tt * keys * (dh + D + dh), 4 * small + big + nbytes(t["k_std"]) + 8 * Bt * H * Tt, "bf16"),
               timed(lib_fwd, 20))
    record("K4 bwd", "rel_attention_train_bwd", err_bwd, ok_bwd,
           timed(backward_call(rel_attention_train), 20), timed(backward_call(rel_attention_train_plain), 5),
           (2.0 * H * Tt * keys * ((dh + D) + 4 * dh + D), 7 * small + 2 * big + nbytes(t["k_std"]) + 8 * Bt * H * Tt,
            "bf16"),
           timed(lib_make_bwd(), 20))
    with torch.no_grad():
        # library: the same SDPA call (the factored operands give the same scores)
        record("K5 fwd", "rel_attention_shift", err_k5, ok_k5,
               timed(lambda: rel_attention(*args), 20), timed(lambda: rel_attention_plain_shift(*args), 5),
               (2.0 * H * Tt * keys * 3 * dh, 5 * small + nbytes(t["pos"]), "bf16"), timed(lib_fwd, 20))
    del t, lib_fwd, lib_make_bwd
    torch.cuda.empty_cache()
    # The same at the flagship's fp32 training shape (--dtype float32: the fp32 kernels of
    # rel_attention_train.cu), beside SDPA in fp32 with TF32 off.
    print("-- the training attention (K4) at the training path's shape in fp32: B=32, T=250, rate 0.1; K5 in fp32 "
          "there too (the flagship's fp32 evaluation step with \"pallas\")", flush=True)
    t = attention_inputs(Bt, Tt, torch.float32, seed=2)
    got = train_attention_run(rel_attention_train, t, 77, 0.1)
    ref = train_attention_run(rel_attention_train_plain, t, 77, 0.1)
    (err_fwd, ok_fwd), (err_bwd, ok_bwd) = (worst(got[sl], ref[sl], att_tol[torch.float32])
                                            for sl in (slice(0, 1), slice(1, 5)))
    del got, ref
    keys = float(torch.where(t["lengths"] > 0, t["lengths"], Tt).sum())
    small, big = nbytes(t["q_u"]), nbytes(t["q_rot"])
    lib_fwd, lib_make_bwd = sdpa_call(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], t["lengths"], scale)
    with torch.no_grad():
        record("K4 fwd fp32", "rel_attention_train_fwd_fp32", err_fwd, ok_fwd,
               timed(fwd(rel_attention_train), 20), timed(fwd(rel_attention_train_plain), 5),
               (2.0 * H * Tt * keys * (dh + D + dh), 4 * small + big + nbytes(t["k_std"]) + 8 * Bt * H * Tt, "fp32"),
               timed(lib_fwd, 20))
    record("K4 bwd fp32", "rel_attention_train_bwd_fp32", err_bwd, ok_bwd,
           timed(backward_call(rel_attention_train), 20), timed(backward_call(rel_attention_train_plain), 5),
           (2.0 * H * Tt * keys * ((dh + D) + 4 * dh + D), 7 * small + 2 * big + nbytes(t["k_std"]) + 8 * Bt * H * Tt,
            "fp32"),
           timed(lib_make_bwd(), 20))
    # K5 in fp32 on the same rows (library: the same SDPA call, 288-wide head)
    args = (t["q_u"], t["q_v"], t["k"], t["v"], t["pos"], t["lengths"])
    err_k5, ok_k5 = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[torch.float32])
    with torch.no_grad():
        record("K5 fwd fp32", "rel_attention_shift_fp32", err_k5, ok_k5,
               timed(lambda: rel_attention(*args), 20), timed(lambda: rel_attention_plain_shift(*args), 5),
               (2.0 * H * Tt * keys * 3 * dh, 5 * small + nbytes(t["pos"]), "fp32"), timed(lib_fwd, 20))
    for name, fn_, lib_, kernel_name in (("K4 fwd fp32", fwd(rel_attention_train), lib_fwd, "train_"),
                                         ("K4 bwd fp32", backward_call(rel_attention_train), lib_make_bwd(), "train_"),
                                         ("K5 fwd fp32", lambda: rel_attention(*args), lib_fwd, "shift_")):
        with torch.no_grad():
            print(f"  {name} B={Bt} T={Tt} device ms under the profiler: the attention kernels "
                  f"{device_ms(fn_, name=kernel_name):.4f}, SDPA fp32 {device_ms(lib_):.4f}", flush=True)
    del t, args, lib_fwd, lib_make_bwd
    torch.cuda.empty_cache()

    # ---- the training path at full width
    print("-- training path: flagship model, B=32 x 9.3-10 s, bf16, attention_dropout 0.1", flush=True)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_train")
    trainer, batches = training_setup(seed=0, batch_size=32, n_batches=6, checkpoint_dir=ckpt_dir)
    twin = copy.deepcopy(trainer.model)  # the same initial state, for the plain-attention step
    state = trainer.init_state()
    fixed = batches[0]
    loss_before = float(trainer.eval_step(state, fixed)["loss"])
    step_events, logged = [], []
    plain_step = trainer.train_step

    def timed_step(st, batch):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = plain_step(st, batch)
        end.record()
        step_events.append((start, end))
        return result

    trainer.train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    state = trainer.fit(state, PrefetchIterator(iter(batches), depth=2, device_put=pinned_device_put(dev)),
                        hooks=[lambda step, m: logged.append(m)])
    evaluated = trainer.eval_step(state, fixed)
    loss_after = float(evaluated["loss"])
    trainer.save_checkpoint(state)
    final_dir = os.path.join(ckpt_dir, "final")
    save_params(state.model, final_dir)
    trained_pipe = ASRPipeline(final_dir, model_type="ctc", tokenizer=PieceTable(), numeric_profile="exact")
    trained_request = {"trained model, 1 utt (6 s)": [speech(6.0, rng)]}
    served = trained_pipe(trained_request["trained model, 1 utt (6 s)"])
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [a.elapsed_time(b) for a, b in step_events]
    for i, m in enumerate(logged):
        print(f"  step {i + 1}: loss={m['loss']:.4f} grad_norm={m['grad_norm']:.3f} "
              f"applied={int(m['step_applied'])} {step_ms[i]:.1f} ms", flush=True)
    print(f"  fixed batch, dropout off: loss {loss_before:.4f} -> {loss_after:.4f}; "
          f"greedy tokens per utterance {evaluated['token_lengths'].float().mean():.1f}; "
          f"served from the saved model: {served[0][:40]!r}", flush=True)
    print(f"  train step time (median of steps 3-6): {float(np.median(step_ms[2:])):.1f} ms; "
          f"peak memory {peak_gib:.2f} GiB; {smi}", flush=True)
    print(f"  launches in the training phase: {train_launches}", flush=True)
    n_layers, n_steps = cfg.num_hidden_layers, len(batches)
    if len(logged) != n_steps or state.step != n_steps:
        _fail(f"trainer took {state.step} steps, logged {len(logged)}")
    if not all(np.isfinite(m["loss"]) for m in logged) or not np.isfinite(loss_after):
        _fail("non-finite training loss")
    if any(int(m["step_applied"]) != 1 for m in logged) or int(state.skipped_steps) or int(state.nonfinite_steps):
        _fail("the guard rejected a step")
    guard = trainer.config.max_grad_norm_guard
    if max(m["grad_norm"] for m in logged) >= 0.5 * guard:
        _fail(f"a step's gradient norm reached half the guard's threshold of {guard}")
    if not loss_after < loss_before:
        _fail(f"the fixed batch's loss did not go down: {loss_before} -> {loss_after}")
    want = {"asr_rel_attention_train_fwd": n_layers * n_steps, "asr_rel_attention_train_bwd": n_layers * n_steps,
            "asr_rel_attention_shift": n_layers}
    if any(train_launches.get(k, 0) != v for k, v in want.items()):
        _fail(f"attention kernel launches {train_launches} != {want}")
    if len(served) != 1 or not isinstance(served[0], str):
        _fail("the saved model did not serve a request")
    # the served request again, kernel path vs plain path on the trained weights
    against_plain_path(trained_pipe, trained_request)

    # Step 1 again, from the same initial state, streams and batch, with the
    # plain attention version on the card. The two differ by the bf16 rounding
    # flips of 12 layers of attention and by the order of atomic sums: loss within
    # 1e-4, gradient norm within 1e-3 (measured 7e-6 and 2e-4).
    trainer_plain, _ = training_setup(seed=0, batch_size=32, n_batches=0)
    trainer_plain.model.load_state_dict(twin.state_dict())
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = trainer_plain.train_step(trainer_plain.init_state(), fixed)
        if dict(_build.LAUNCHES) != before:
            _fail("the plain-attention step launched a kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    d_loss = abs(logged[0]["loss"] - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    d_norm = abs(logged[0]["grad_norm"] - float(m_plain["grad_norm"])) / float(m_plain["grad_norm"])
    print(f"  step 1, kernels vs plain attention: loss {logged[0]['loss']:.5f} vs {float(m_plain['loss']):.5f} "
          f"(rel {d_loss:.2e}, tol 1e-4); grad norm {logged[0]['grad_norm']:.4f} vs "
          f"{float(m_plain['grad_norm']):.4f} (rel {d_norm:.2e}, tol 1e-3)", flush=True)
    if d_loss > 1e-4 or d_norm > 1e-3:
        _fail("step 1 with the attention kernels disagrees with the plain-attention step")

    # ---- the configs beside the flagship, each at full size: one routine
    # holds every kernel of a layer against its plain version at the shapes
    # the config's paths give it, one holds K4 and K5 at its attention
    # widths, one serves its requests; then its training path.

    @torch.no_grad()
    def layer_holds(title, cfg_, fm, keys, seed):
        """Every kernel of layer 0 of ``fm`` (the FusedCTC of ``cfg_``) at the
        shapes a B=8 x 10 s request gives it, against its plain version, with
        bound, library call and device time: the LayerNorm; the three
        LayerNorm-fed GEMMs with the LayerNorm in their prologue
        (``ln_gemm_hold``: also bit-equal to layer_norm then gemm); each other
        GEMM of the layer with its epilogue, into a column slice of a buffer
        whose other columns and rows must stay untouched (2^-6); pos_query and
        the attention (also at the 2 s and 20 s buckets), whose pad columns
        must be zero; both depthwise convs at t_valid T, 1, T_pad and 0; the
        whole layer against the sum of its 14 pieces' bounds (0.05 of scale).
        ``keys`` names each kernel's JSON entry. Returns layer 0's weights, the
        padded length and its tables."""
        D_, H_, dh_ = cfg_.hidden_size, cfg_.num_attention_heads, cfg_.head_size
        w_ = fm.layers[0]
        hw_, d_rot_ = w_["wp"].shape[2], K1.rot_width(D_)
        I_, Cg_ = w_["ff1_wi"].shape[1], w_["cg_w2"].shape[0]
        Kc_, Km_ = w_["csgu_dw"].shape[0], w_["merge_dw"].shape[0]
        eps = cfg_.layer_norm_eps
        B_, T_ = 8, int(feat_extract_output_frames(cfg_, 998))
        T_pad_ = -(-T_ // 8) * 8
        M_ = B_ * T_pad_
        print(f"-- {title}: {cfg_.num_hidden_layers} layers x {D_}, {H_} heads of {dh_} (kernel width {hw_}), "
              f"q_rot {D_} (kernel width {d_rot_}), I={I_} (CSGU {Cg_} channels, merge {2 * D_}); "
              f"B={B_}, 10 s: T={T_}, T_pad={T_pad_}", flush=True)
        gen_ = torch.Generator().manual_seed(seed)
        mk = lambda *shape: torch.randn(*shape, generator=gen_).bfloat16().to(dev)  # noqa: E731
        tab_ = fm.tables(T_pad_)
        lens_ = torch.tensor([T_ - (i * T_) // (2 * B_) for i in range(B_)], dtype=torch.int32, device=dev)
        lens_[B_ // 2], lens_[B_ - 1] = 1, 0  # an utterance of one frame and one of none
        x_ = mk(B_, T_pad_, D_)
        xf_ = x_.view(M_, D_)

        work_ln = (8.0 * M_ * D_, 4 * M_ * D_, "fp32")
        ln_g16, ln_b16 = w_["attn_ln_g"].bfloat16(), w_["attn_ln_b"].bfloat16()
        compare(f"layernorm D={D_}", keys["layernorm"],
                     lambda: K1.layer_norm(xf_, w_["attn_ln_g"], w_["attn_ln_b"], eps),
                     lambda: K1.layer_norm_plain(xf_, w_["attn_ln_g"], w_["attn_ln_b"], eps), 2 ** -7,
                     library_fn=lambda: F.layer_norm(xf_, (D_,), ln_g16, ln_b16, eps), work=work_ln)

        for name, ln_key, wk, bk, kw in (("ff1_in (+act)", "ff1", "ff1_wi", "ff1_bi", dict(act=cfg_.hidden_act)),
                                         ("qkv (dual)", "attn", "w_qkv", "b_qkv", dict(bias2=w_["bq_v"])),
                                         ("cg_w1 (+gelu)", "cg", "cg_w1", "cg_b1", dict(act="gelu"))):
            ln_gemm_hold(f"ln_gemm {name} K={D_} N={w_[wk].shape[1]}", keys["gemm_ln"], xf_, w_[f"{ln_key}_ln_g"],
                         w_[f"{ln_key}_ln_b"], eps, w_[wk], w_[bk], **kw)
        # (name, input or None for a seeded one, weight, bias, epilogue, first column of the output)
        gemms = [("ff1_out (+res)", None, "ff1_wo", "ff1_bo", dict(residual=xf_, alpha=0.5), 16),
                 ("wo -> merged[:, :D]", None, "wo", "bo", {}, 0),
                 ("cg_w2 -> merged[:, D:]", None, "cg_w2", "cg_b2", {}, D_),
                 ("merge_w (+res)", None, "merge_w", "merge_b", dict(residual=xf_, alpha=1.0), 16)]
        for name, a_, wk, bk, kw, lead in gemms:
            K_, N_ = w_[wk].shape
            a_ = a_ if a_ is not None else mk(M_, K_)
            guard = torch.full((M_ + 8, lead + N_ + 16), 7.0, dtype=torch.bfloat16, device=dev)
            out_view = guard[:M_, lead:lead + N_]
            extra = (2 * M_ * N_ if "residual" in kw else 0) + (2 * M_ * kw["bias2"].shape[0] if "bias2" in kw else 0)
            run = lambda: K1.gemm(a_, w_[wk], w_[bk], out=out_view, **kw)  # noqa: E731
            lib = lambda wt=w_[wk].t(), b16=w_[bk].bfloat16(): F.linear(a_, wt, b16)  # noqa: E731
            got = compare(f"gemm {name} K={K_} N={N_}", keys["gemm"], run,
                          lambda: K1.gemm_plain(a_, w_[wk], w_[bk], **kw), 2 ** -6,
                          work=gemm_work(M_, K_, N_, extra), library_fn=lib)
            if "bias2" in kw:
                ref2 = K1.gemm_plain(a_, w_[wk], w_[bk], **kw)[1].float()
                if float((got[1].float() - ref2).abs().max()) > 2 ** -6 * max(1.0, float(ref2.abs().max())):
                    failures.append(f"gemm {name} K={K_} N={N_}: second output")
            print(f"    device ms under the profiler: kernel {device_ms(run):.4f}, F.linear (bf16, no epilogue) "
                  f"{device_ms(lib):.4f}", flush=True)
            torch.cuda.synchronize()
            if not bool((guard[:, :lead] == 7.0).all()) or not bool((guard[:, lead + N_:] == 7.0).all()) \
                    or not bool((guard[M_:] == 7.0).all()):
                failures.append(f"gemm {name} K={K_} N={N_}: wrote outside its slice")

        qkv_, q_v_ = K1.ln_gemm(xf_, w_["attn_ln_g"], w_["attn_ln_b"], eps, w_["w_qkv"], w_["b_qkv"], bias2=w_["bq_v"])
        work_pq = (2.0 * M_ * H_ * dh_ * D_ + 6.0 * M_ * H_ * D_,
                   2 * M_ * H_ * dh_ + 2 * H_ * dh_ * D_ + 2 * T_pad_ * D_ + 2 * M_ * H_ * D_, "bf16")
        pq = (q_v_, w_["wp"], tab_["rot_cos"], tab_["rot_sin"], T_pad_)
        q_rot_ = compare(f"pos_query dh={dh_} q_rot={D_}", keys["pos_query"], lambda: K1.pos_query(*pq),
                         lambda: K1.pos_query_plain(*pq), 2 ** -7, library_fn=pos_query_library(q_v_, w_["wp"]),
                         work=work_pq)
        pad = (d_rot_ - D_) // 2
        if pad and (q_rot_[..., D_ // 2:D_ // 2 + pad].any() or q_rot_[..., d_rot_ - pad:].any()):
            failures.append(f"pos_query dh={dh_}: a pad column of q_rot is not zero")
        hv = lambda i: qkv_[:, i * H_ * hw_:(i + 1) * H_ * hw_].view(B_, T_pad_, H_, hw_)  # noqa: E731
        att = (hv(0), hv(1), hv(2), q_rot_.view(B_, T_pad_, H_, d_rot_), tab_["k_std"], lens_)
        n_keys = float(torch.where(lens_ > 0, lens_, T_pad_).sum())
        work_att = (2.0 * H_ * T_pad_ * n_keys * (dh_ + D_ + dh_),
                    2 * M_ * H_ * D_ + 2 * T_pad_ * D_ + 4 * 2 * M_ * H_ * dh_, "bf16")
        attn_ = compare(f"rel_attention dh={dh_} q_rot={D_}", keys["rel_attention"], lambda: K1.rel_attention(*att),
                        lambda: K1.rel_attention_plain(*att), 2 ** -6,
                        library_fn=sdpa_call(hv(0), att[3], hv(1), hv(2), tab_["k_std"], lens_, 1.0)[0],
                        work=work_att)
        if hw_ > dh_ and attn_[..., dh_:].any():
            failures.append(f"rel_attention dh={dh_}: a pad column of the output is not zero")
        for Tb in (56, 504):  # the 2 s and 20 s buckets: fewer rows than a block, keys past four tiles
            lens_b = [Tb, 1, 0, Tb - 9, Tb // 2, 65, 64, (3 * Tb) // 4]
            gq = torch.Generator().manual_seed(Tb + seed)
            buf = torch.randn(8 * Tb, 3 * H_ * hw_, generator=gq).bfloat16().to(dev)
            buf.view(-1, 3, H_, hw_)[..., dh_:] = 0.0  # the fold's zero pad columns
            qr_b = (torch.randn(8, Tb, H_, d_rot_, generator=gq) * 0.25).bfloat16().to(dev)
            if pad:
                qr_b[..., D_ // 2:D_ // 2 + pad] = 0.0
                qr_b[..., d_rot_ - pad:] = 0.0
            args_b = tuple(buf[:, i * H_ * hw_:(i + 1) * H_ * hw_].view(8, Tb, H_, hw_) for i in range(3)) + (
                qr_b, fm.tables(Tb)["k_std"], torch.tensor(lens_b, dtype=torch.int32, device=dev))
            compare(f"rel_attention dh={dh_} q_rot={D_} T_pad={Tb}", keys["rel_attention"],
                    lambda: K1.rel_attention(*args_b), lambda: K1.rel_attention_plain(*args_b), 2 ** -6)

        # the depthwise convs: CSGU on the layer's own l, merge on a seeded
        # `merged`; F.conv1d(groups=C) in bf16 on the (B, C, T) layout is the
        # library call, without what the kernels fuse
        l_ = K1.ln_gemm(xf_, w_["cg_ln_g"], w_["cg_ln_b"], eps, w_["cg_w1"], w_["cg_b1"], act="gelu")
        csgu_args = lambda tv: (l_, w_["csgu_ln_g"], w_["csgu_ln_b"], w_["csgu_dw"], w_["csgu_dw_b"],  # noqa: E731
                                B_, T_pad_, tv, cfg_.csgu_activation, eps)
        gate_in = l_[:, Cg_:].reshape(B_, T_pad_, Cg_).transpose(1, 2).contiguous()
        dw_c = w_["csgu_dw"].t().contiguous()[:, None, :]
        lib_csgu = lambda: F.conv1d(gate_in, dw_c, padding=Kc_ // 2, groups=Cg_)  # noqa: E731
        work_csgu = (2.0 * M_ * Cg_ * Kc_ + 10.0 * M_ * Cg_, 2 * M_ * 2 * Cg_ + 2 * Kc_ * Cg_ + 2 * M_ * Cg_, "fp32")
        merged = mk(M_, 2 * D_)
        margs = lambda tv: (merged, w_["merge_dw"], w_["merge_dw_b"], B_, T_pad_, tv)  # noqa: E731
        merged_in = merged.reshape(B_, T_pad_, 2 * D_).transpose(1, 2).contiguous()
        dw_m = w_["merge_dw"].t().contiguous()[:, None, :]
        lib_merge = lambda: F.conv1d(merged_in, dw_m, padding=Km_ // 2, groups=2 * D_)  # noqa: E731
        work_merge = (2.0 * M_ * 2 * D_ * Km_, 2 * 2 * M_ * 2 * D_ + 2 * Km_ * 2 * D_, "fp32")
        for tv in (T_, 1, T_pad_, 0):
            first = {} if tv != T_ else dict(work=work_csgu, library_fn=lib_csgu)
            compare(f"dwconv csgu C={Cg_} t_valid={tv}", keys["dwconv_csgu"], lambda: K1.csgu(*csgu_args(tv)),
                    lambda: K1.csgu_plain(*csgu_args(tv)), 2 ** -7, **first)
        for tv in (T_, 1, T_pad_, 0):
            first = {} if tv != T_ else dict(work=work_merge, library_fn=lib_merge)
            compare(f"dwconv merge C={2 * D_} t_valid={tv}", keys["dwconv_merge"], lambda: K1.merge_conv(*margs(tv)),
                    lambda: K1.merge_conv_plain(*margs(tv)), 2 ** -7, **first)

        layer_pieces = layer_work(M_, D_, I_, Cg_, work_ln, work_pq, work_att, work_csgu, work_merge)  # true widths
        compare(f"layer (K1 whole) D={D_}", None, lambda: K1.ebranchformer_layer(x_, lens_, w_, cfg_, T_, tab_),
                lambda: K1.ebranchformer_layer_plain(x_, lens_, w_, cfg_, T_, tab_), 0.05, work=layer_pieces)
        dev_ms = {
            "layernorm": device_ms(lambda: K1.layer_norm(xf_, w_["attn_ln_g"], w_["attn_ln_b"], eps)),
            "F.layer_norm": device_ms(lambda: F.layer_norm(xf_, (D_,), ln_g16, ln_b16, eps)),
            "pos_query": device_ms(lambda: K1.pos_query(*pq)),
            "torch.bmm": device_ms(pos_query_library(q_v_, w_["wp"])),
            "rel_attention": device_ms(lambda: K1.rel_attention(*att)),
            "dwconv csgu": device_ms(lambda: K1.csgu(*csgu_args(T_))),
            "F.conv1d csgu": device_ms(lib_csgu),
            "dwconv merge": device_ms(lambda: K1.merge_conv(*margs(T_))),
            "F.conv1d merge": device_ms(lib_merge),
            "layer": device_ms(lambda: K1.ebranchformer_layer(x_, lens_, w_, cfg_, T_, tab_)),
        }
        print(f"  device ms per call under the profiler (B={B_}, 10 s, D={D_}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)
        return w_, T_pad_, tab_

    def train_attention_holds(tag, H_, dh_, D_, keys, dtypes, seed, fp32_keys=None):
        """K4 (forward and the four gradients) and K5 at head size ``dh_`` and
        q_rot width ``D_`` (the wrappers pad to the kernels' widths) against
        their plain versions: B=8 x T=250 and B=4 x T=333 with rows of length 1
        and 0, at rates 0 and 0.1, in each of ``dtypes``; then at a training
        step's B=32, T=250, bf16, rate 0.1, timed beside SDPA on the
        concatenated head, and the wrappers' device time split into the
        attention kernels' own and the rest (the pad copies; where the
        backward writes dS, its zeroing and the dq_rot GEMM). ``fp32_keys``
        ({batch size: keys}): K4 in fp32 held and timed the same way at those
        batch sizes, T=250, beside SDPA in fp32 (K5 too where the keys name it)."""
        def inputs(B, T, dtype, lens, s):
            g = torch.Generator().manual_seed(s)
            mk = lambda *shape: torch.randn(*shape, generator=g).to(dtype).to(dev)  # noqa: E731
            return dict(q_u=mk(B, T, H_, dh_), q_rot=mk(B, T, H_, D_) * 0.25, k=mk(B, T, H_, dh_),
                        v=mk(B, T, H_, dh_), k_std=mk(T, D_), q_v=mk(B, T, H_, dh_), pos=mk(2 * T - 1, H_, dh_),
                        cot=mk(B, T, H_, dh_), lengths=torch.tensor(lens, dtype=torch.int32, device=dev))

        print(f"-- K4 and K5 at {tag} vs plain, lengths with 1 and 0", flush=True)
        for T, lens in ((250, [250, 1, 0, 167, 250, 200, 64, 65]), (333, [333, 1, 0, 200])):
            for dtype in dtypes:
                t = inputs(len(lens), T, dtype, lens, seed + T)
                label = f"{tag} T={T} {str(dtype).split('.')[-1]}"
                for rate in (0.0, 0.1):
                    got = train_attention_run(rel_attention_train, t, 77, rate)
                    ref = train_attention_run(rel_attention_train_plain, t, 77, rate)
                    for part, sl in (("fwd", slice(0, 1)), ("bwd (4 gradients)", slice(1, 5))):
                        err, ok = worst(got[sl], ref[sl], att_tol[dtype])
                        print(f"  K4 {part:18s} {label + f' rate={rate}':36s} max_abs_err={err:.3e} "
                              f"{'ok' if ok else 'FAIL'}", flush=True)
                        if not ok:
                            failures.append(f"K4 {part} {label} rate={rate}")
                args = (t["q_u"], t["q_v"], t["k"], t["v"], t["pos"], t["lengths"])
                err, ok = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[dtype])
                print(f"  K5 {'fwd':18s} {label:36s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failures.append(f"K5 {label}")

        def timed_at(Bt, dtype, keys_, iters):
            """K4 (and K5 where ``keys_`` names it) at B=``Bt``, T=250, rate
            0.1: held against the plain versions, timed beside SDPA in the
            same dtype, device time split."""
            Tt = 250
            t = inputs(Bt, Tt, dtype, [Tt - (i * Tt) // (2 * Bt) for i in range(Bt)], seed + Bt)
            got = train_attention_run(rel_attention_train, t, 77, 0.1)
            ref = train_attention_run(rel_attention_train_plain, t, 77, 0.1)
            (err_fwd, ok_fwd), (err_bwd, ok_bwd) = (worst(got[sl], ref[sl], att_tol[dtype])
                                                    for sl in (slice(0, 1), slice(1, 5)))
            del got, ref
            kind = "bf16" if dtype == torch.bfloat16 else "fp32"
            label = f"{tag} B={Bt} {kind}"
            n_keys = float(t["lengths"].sum())
            small, big = nbytes(t["q_u"]), nbytes(t["q_rot"])
            lib_fwd, lib_make_bwd = sdpa_call(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"], t["lengths"],
                                              1.0 / float(np.sqrt(dh_)))

            def backward_of(fn):
                leaves = [t[n].clone().requires_grad_(True) for n in ("q_u", "q_rot", "k", "v")]
                out = fn(*leaves, t["k_std"], t["lengths"], 77, 0.1)
                return lambda: torch.autograd.grad(out, leaves, t["cot"], retain_graph=True)

            forward_of = lambda fn: (lambda: fn(t["q_u"], t["q_rot"], t["k"], t["v"], t["k_std"],  # noqa: E731
                                                t["lengths"], 77, 0.1))
            with torch.no_grad():
                record(f"K4 fwd {label}", keys_["fwd"], err_fwd, ok_fwd,
                       timed(forward_of(rel_attention_train), iters),
                       timed(forward_of(rel_attention_train_plain), 5),
                       (2.0 * H_ * Tt * n_keys * (dh_ + D_ + dh_),
                        4 * small + big + nbytes(t["k_std"]) + 8 * Bt * H_ * Tt, kind), timed(lib_fwd, iters))
            # the backward's bytes: its inputs and the four gradients once (a dS
            # scratch it writes and reads back is the design's, not the function's)
            record(f"K4 bwd {label}", keys_["bwd"], err_bwd, ok_bwd,
                   timed(backward_of(rel_attention_train), iters), timed(backward_of(rel_attention_train_plain), 5),
                   (2.0 * H_ * Tt * n_keys * ((dh_ + D_) + 4 * dh_ + D_),
                    7 * small + 2 * big + nbytes(t["k_std"]) + 8 * Bt * H_ * Tt, kind),
                   timed(lib_make_bwd(), iters))
            splits = {"K4 fwd": (forward_of(rel_attention_train), "train_fwd_"),
                      "K4 bwd": (backward_of(rel_attention_train), "train_bwd_")}
            if "shift" in keys_:
                args = (t["q_u"], t["q_v"], t["k"], t["v"], t["pos"], t["lengths"])
                err_k5, ok_k5 = worst([rel_attention(*args)], [rel_attention_plain_shift(*args)], att_tol[dtype])
                with torch.no_grad():
                    record(f"K5 fwd {label}", keys_["shift"], err_k5, ok_k5,
                           timed(lambda: rel_attention(*args), iters),
                           timed(lambda: rel_attention_plain_shift(*args), 5),
                           (2.0 * H_ * Tt * n_keys * 3 * dh_, 5 * small + nbytes(t["pos"]), kind),
                           timed(lib_fwd, iters))
                splits["K5"] = (lambda: rel_attention(*args), "shift_")
            for name, (fn, kernel_name) in splits.items():
                per_kernel = device_kernel_ms(fn)
                total = sum(per_kernel.values())
                own = sum(v for k, v in per_kernel.items() if kernel_name in k)
                lib = device_ms(lib_fwd) if name != "K4 bwd" else device_ms(lib_make_bwd())
                print(f"  {name} {label} T={Tt} device ms under the profiler: {total:.4f}, the attention kernels "
                      f"{own:.4f}, the rest {total - own:.4f}; SDPA {lib:.4f}", flush=True)
            del t, lib_fwd, lib_make_bwd
            torch.cuda.empty_cache()

        timed_at(32, torch.bfloat16, keys, 20)
        for Bt, keys_ in (fp32_keys or {}).items():
            timed_at(Bt, torch.float32, keys_, 5)

    def serve_requests(title, cfg_, model_, requests):
        """``model_`` saved and served through ``ASRPipeline(model_type="ctc")``
        on the card, each request with its own launch counts (per layer one
        LayerNorm, 4 GEMMs with the LayerNorm prologue, 5 other GEMMs and one
        of each other layer kernel; one log-mel launch; no conv1: the model's
        own front end), then every request against the plain path. Returns
        (the launches summed over the requests, valid frames, frames whose
        greedy ids agree). Then the first request once more in the serving
        profile: its serving kernels launched (per layer 3 GELU epilogues with
        a GELU ``hidden_act``, else 1, each in a GEMM with the LayerNorm
        prologue, and the serving attention), no exact attention, against the
        serving plain path."""
        model_dir_ = os.path.join(ROOT, "build", f"chip_smoke_model_{cfg_.hidden_size}")
        save_params(model_, model_dir_)
        pipe_ = ASRPipeline(model_dir_, model_type="ctc", device="cuda", tokenizer=PieceTable(),
                            numeric_profile="exact")
        if not pipe_._use_fused:
            _fail(f"the pipeline did not select the fused kernel path for the {title} config")
        pipe_(next(iter(requests.values()))[:1])  # first call: warm the allocator
        torch.cuda.synchronize()
        per_layer = {"asr_layernorm_bf16": 1, "asr_gemm_ln_bf16": 4, "asr_gemm_bf16": 5, "asr_rel_attention": 1,
                     "asr_pos_query": 1, "dwconv_csgu": 1, "dwconv_merge": 1}
        want = {k: v * cfg_.num_hidden_layers for k, v in per_layer.items()}
        summed = {}
        for name, audios in requests.items():
            _build.reset_launch_counts()
            t0_ = time.perf_counter()
            texts = pipe_(audios)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0_) * 1e3
            got_l = dict(_build.LAUNCHES)
            for k, v in got_l.items():
                summed[k] = summed.get(k, 0) + v
            print(f"request {name}: {ms:.1f} ms; launches {got_l}", flush=True)
            if len(texts) != len(audios) or any(got_l.get(k, 0) != v for k, v in want.items()) \
                    or got_l.get("asr_log_mel", 0) != 1 or got_l.get("asr_conv1", 0) != 0:
                _fail(f"{name}: {len(texts)} transcripts, launches {got_l}, want {want} and one mel, no conv1")
        frames, agree = against_plain_path(pipe_, requests)
        del pipe_
        pipe_ = ASRPipeline(model_dir_, model_type="ctc", device="cuda", tokenizer=PieceTable(),
                            numeric_profile="serving")
        first = dict([next(iter(requests.items()))])
        (name, audios), = first.items()
        pipe_(audios[:1])  # warm-up
        texts, got_s = count_launches(lambda: pipe_(audios), {})
        n_l = cfg_.num_hidden_layers
        want_s = {"asr_log_mel_bf16": 1, "asr_rel_attention_serving": n_l,
                  "asr_gemm_ln_gelu_serving": (3 if cfg_.hidden_act == "gelu" else 1) * n_l}
        print(f"request {name}, serving profile: launches {got_s}", flush=True)
        if len(texts) != len(audios) or any(got_s.get(k, 0) != v for k, v in want_s.items()) \
                or "asr_rel_attention" in got_s:
            _fail(f"{name}, serving: {len(texts)} transcripts, launches {got_s}, want {want_s}")
        against_plain_path(pipe_, first)
        del pipe_
        torch.cuda.empty_cache()
        return summed, frames, agree

    # the 176-wide config (configs/ebranchformer_small_ctc.json): head size 44
    # (padded to 64 columns), q_rot 176 wide (padded to 192), the GEMM's edge
    # tiles at N = 176 and K = 176, and K1 behind the model's own conv front end
    ncfg = config_file(SMALL_CONFIG)
    n_model = seeded_model(ncfg, seed=1)
    nf = FusedCTC(n_model, dev)
    if nf.subsample is not None:
        _fail("the 176-wide config took the subsampler kernel")
    nw, nT_pad, n_tab = layer_holds(f"176-wide config ({SMALL_CONFIG})", ncfg, nf, seed=176, keys=dict(
        layernorm="layernorm_d176", gemm="gemm_d176", gemm_ln="gemm_ln_d176", pos_query="pos_query_dh44",
        rel_attention="rel_attention_dh44",
        dwconv_csgu="dwconv_csgu_c352", dwconv_merge="dwconv_merge_c352"))
    nD, nH, n_dh = ncfg.hidden_size, ncfg.num_attention_heads, ncfg.head_size
    hw, d_rot = nw["wp"].shape[2], K1.rot_width(nD)
    pad = (d_rot - nD) // 2
    with torch.no_grad():
        # pos_query at the rows of a B=128 x 10 s request (q_v's pad columns zero, as the fold makes them)
        nM_big = 128 * nT_pad
        q_v_nb = torch.randn(nM_big, nH * hw, generator=torch.Generator().manual_seed(177)).bfloat16().to(dev)
        q_v_nb.view(nM_big, nH, hw)[..., n_dh:] = 0.0
        npq_big = (q_v_nb, nw["wp"], n_tab["rot_cos"], n_tab["rot_sin"], nT_pad)
        q_rot_nb = compare("pos_query dh=44 B=128", "pos_query_dh44_b128", lambda: K1.pos_query(*npq_big),
                           lambda: K1.pos_query_plain(*npq_big), 2 ** -7,
                           library_fn=pos_query_library(q_v_nb, nw["wp"]),
                           work=(2.0 * nM_big * nH * n_dh * nD + 6.0 * nM_big * nH * nD,
                                 2 * nM_big * nH * n_dh + 2 * nH * n_dh * nD + 2 * nT_pad * nD + 2 * nM_big * nH * nD,
                                 "bf16"))
        if q_rot_nb[..., nD // 2:nD // 2 + pad].any() or q_rot_nb[..., d_rot - pad:].any():
            failures.append("pos_query dh=44 B=128: a pad column of q_rot is not zero")
        print(f"  pos_query dh=44 B=128 device ms under the profiler: {device_ms(lambda: K1.pos_query(*npq_big)):.4f} "
              f"(torch.bmm {device_ms(pos_query_library(q_v_nb, nw['wp'])):.4f})", flush=True)
        del q_v_nb, q_rot_nb, npq_big
    train_attention_holds("dh=44, D=176", nH, n_dh, nD, dict(fwd="rel_attention_train_fwd_dh44",
                          bwd="rel_attention_train_bwd_dh44", shift="rel_attention_shift_dh44"),
                          (torch.bfloat16, torch.float32), seed=44)

    # the 176-wide serving path: requests of 1 and 8 utterances at 10 s and 20 s
    n_requests = {f"176-wide, {n} utt ({sec} s)": [speech(sec * (1.0 - 0.05 * i), rng) for i in range(n)]
                  for sec in (10, 20) for n in (1, 8)}
    narrow_launches, _, _ = serve_requests("176-wide", ncfg, n_model, n_requests)

    # the 176-wide training path: CTCTrainer with the config's attention_impl
    # ("auto": K4 on the card), 3 steps, each with its own launch counts, and
    # step 1 again with the plain attention
    print(f"-- training path: 176-wide config, attention_impl={ncfg.attention_impl!r}, B=32 x 9.3-10 s, bf16, "
          f"attention_dropout {ncfg.attention_dropout}", flush=True)
    n_trainer, n_batches = training_setup(seed=1, batch_size=32, n_batches=3, cfg=ncfg)
    n_twin = copy.deepcopy(n_trainer.model)
    n_state = n_trainer.init_state()
    n_logged, n_step_ms, n_train_launches = [], [], {}
    for i, batch in enumerate(n_batches):
        _build.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        n_state, m = n_trainer.train_step(n_state, batch)
        end.record()
        torch.cuda.synchronize()
        step_l = dict(_build.LAUNCHES)
        n_step_ms.append(start.elapsed_time(end))
        n_logged.append({k: float(v) for k, v in m.items() if k in ("loss", "grad_norm", "step_applied")})
        for k, v in step_l.items():
            n_train_launches[k] = n_train_launches.get(k, 0) + v
        print(f"  step {i + 1}: loss={n_logged[-1]['loss']:.4f} grad_norm={n_logged[-1]['grad_norm']:.3f} "
              f"applied={int(n_logged[-1]['step_applied'])} {n_step_ms[-1]:.1f} ms; K4 launches "
              f"{step_l.get('asr_rel_attention_train_fwd', 0)} fwd, {step_l.get('asr_rel_attention_train_bwd', 0)} bwd",
              flush=True)
        if any(step_l.get(k, 0) != ncfg.num_hidden_layers
               for k in ("asr_rel_attention_train_fwd", "asr_rel_attention_train_bwd")):
            _fail(f"176-wide step {i + 1}: K4 launches {step_l}, want {ncfg.num_hidden_layers} of each")
        if int(n_logged[-1]["step_applied"]) != 1 or not np.isfinite(n_logged[-1]["loss"]):
            _fail(f"176-wide step {i + 1} was not applied or its loss is not finite")
    print(f"  176-wide train step time (median of 3): {float(np.median(n_step_ms)):.1f} ms; {smi}", flush=True)
    n_plain, _ = training_setup(seed=1, batch_size=32, n_batches=0, cfg=ncfg)
    n_plain.model.load_state_dict(n_twin.state_dict())
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = n_plain.train_step(n_plain.init_state(), n_batches[0])
        if dict(_build.LAUNCHES) != before:
            _fail("the 176-wide plain-attention step launched a kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    d_loss = abs(n_logged[0]["loss"] - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    print(f"  176-wide step 1, kernels vs plain attention: loss {n_logged[0]['loss']:.5f} vs "
          f"{float(m_plain['loss']):.5f} (rel {d_loss:.2e}, tol 1e-4)", flush=True)
    if d_loss > 1e-4:
        _fail("176-wide step 1 with the attention kernels disagrees with the plain-attention step")
    # an evaluation step of the trained weights with "pallas" runs K5 at dh 44
    n_evaluator, _ = training_setup(seed=1, batch_size=32, n_batches=0,
                                    cfg=dataclasses.replace(ncfg, attention_impl="pallas"))
    n_evaluator.model.load_state_dict(n_state.model.state_dict())
    _build.reset_launch_counts()
    ev = n_evaluator.eval_step(n_evaluator.init_state(), n_batches[0])
    torch.cuda.synchronize()
    n_eval_launches = dict(_build.LAUNCHES)
    if n_eval_launches.get("asr_rel_attention_shift", 0) != ncfg.num_hidden_layers or not np.isfinite(float(ev["loss"])):
        _fail(f"176-wide evaluation with 'pallas': launches {n_eval_launches}")
    narrow_launches.update({k: v for k, v in n_train_launches.items() if k.startswith("asr_rel_attention_train")})
    narrow_launches["asr_rel_attention_shift"] = n_eval_launches["asr_rel_attention_shift"]

    # ---- the 512-wide config (configs/ebranchformer_90m_ssl.json: 17 layers x
    # 512, 8 heads of 64, I=2048, conv_dim (512, 512), outside K2): q_rot 512
    # wide (the k_std chunk ring of K1's attention and K4's forward), the K4
    # backward that writes dS (dq_rot by the GEMM), the CSGU conv at 1,024
    # channels (128-channel slices behind the row-statistics pass), the GEMM
    # at N and K of 512, 1,024, 1,536 and 2,048, the LayerNorm at 512 and the
    # merge conv at 1,024 channels. Its kernels against their plain versions
    # at the shapes its paths give them, then the serving path (4 CTC
    # requests, a 500 + 1 head) and BEST-RQ pretraining (3 steps and an
    # evaluation of cli/pretrain.run).
    wide_t0 = time.perf_counter()
    wcfg = dataclasses.replace(config_file(WIDE_CONFIG), vocab_size=500)
    w_model = seeded_model(wcfg, seed=2)
    wf = FusedCTC(w_model, dev)
    if wf.subsample is not None:
        _fail("the 512-wide config took the subsampler kernel")
    layer_holds(f"512-wide config ({WIDE_CONFIG})", wcfg, wf, seed=512, keys=dict(
        layernorm="layernorm_d512", gemm="gemm_d512", gemm_ln="gemm_ln_d512", pos_query="pos_query_q512",
        rel_attention="rel_attention_q512",
        dwconv_csgu="dwconv_csgu_c1024", dwconv_merge="dwconv_merge_c1024"))
    del wf
    # K4 at (dh 64, q_rot 512) in bf16 and fp32 and K5 at dh 64; fp32 K4 (and K5) also timed at the fp32
    # training runs' B=16 and at B=32
    wH, w_dh, wD = wcfg.num_attention_heads, wcfg.head_size, wcfg.hidden_size
    train_attention_holds("dh=64, q_rot=512", wH, w_dh, wD,
                          dict(fwd="rel_attention_train_fwd_q512", bwd="rel_attention_train_bwd_q512",
                               shift="rel_attention_shift_dh64"), (torch.bfloat16, torch.float32), seed=512,
                          fp32_keys={16: dict(fwd="rel_attention_train_fwd_q512_fp32",
                                              bwd="rel_attention_train_bwd_q512_fp32",
                                              shift="rel_attention_shift_dh64_fp32"),
                                     32: dict(fwd="rel_attention_train_fwd_q512_fp32_b32",
                                              bwd="rel_attention_train_bwd_q512_fp32_b32")})
    # fp32 K4 at the edges: a padded head and q_rot, (40, 312) -> (64, 320), one ragged key tile at T=70; and
    # the fp32 q_rot-256 time beside 512's (B=16, T=250, rate 0.1), as a reference
    for (e_dh, eD), (eB, eT, e_lens) in (((40, 312), (3, 70, [70, 1, 0])), ((64, 256), (16, 250, None))):
        g = torch.Generator().manual_seed(eD + eT)
        mk = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
        e_lens = e_lens or [eT - (i * eT) // (2 * eB) for i in range(eB)]
        te = dict(q_u=mk(eB, eT, wH, e_dh), q_rot=mk(eB, eT, wH, eD) * 0.25, k=mk(eB, eT, wH, e_dh),
                  v=mk(eB, eT, wH, e_dh), k_std=mk(eT, eD), cot=mk(eB, eT, wH, e_dh),
                  lengths=torch.tensor(e_lens, dtype=torch.int32, device=dev))
        label = f"fp32 dh={e_dh}, q_rot={eD} B={eB} T={eT}"
        for rate in (0.0, 0.1):
            got = train_attention_run(rel_attention_train, te, 77, rate)
            err, ok = worst(got, train_attention_run(rel_attention_train_plain, te, 77, rate), att_tol[torch.float32])
            print(f"  K4 fwd + bwd {label} rate={rate}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K4 {label} rate={rate}")
        if eD == 256:
            fwd_fn = lambda: rel_attention_train(te["q_u"], te["q_rot"], te["k"], te["v"], te["k_std"],  # noqa: E731
                                                 te["lengths"], 77, 0.1)
            leaves = [te[n].clone().requires_grad_(True) for n in ("q_u", "q_rot", "k", "v")]
            out = rel_attention_train(*leaves, te["k_std"], te["lengths"], 77, 0.1)
            bwd_fn = lambda: torch.autograd.grad(out, leaves, te["cot"], retain_graph=True)  # noqa: E731
            with torch.no_grad():
                fwd_ms, fwd_dev = timed(fwd_fn, 5), device_ms(fwd_fn, name="train_fwd_")
            print(f"  K4 {label} (reference): fwd {fwd_ms:.4f} ms, bwd {timed(bwd_fn, 5):.4f} ms (events); device "
                  f"fwd {fwd_dev:.4f}, bwd {device_ms(bwd_fn, name='train_bwd_'):.4f}; {smi}", flush=True)
            del leaves, out
        del te
    # the fp32 kernel's keep-mask at (dh 64, q_rot 512), read out of the kernel itself as in step 6
    same_mask = kernel_keep_mask(4, 250, wH, w_dh, wD, torch.float32, row0=0)
    if not same_mask:
        failures.append("K4 fp32 keep-mask at q_rot 512")

    # the 512-wide serving path: four requests of 8 x 10 s
    w_requests = {f"512-wide, 8 utts (10 s) #{r}": [speech(10.0 * (1.0 - 0.01 * ((i + r) % 7)), rng) for i in range(8)]
                  for r in range(4)}
    wide_launches, w_frames, w_agree = serve_requests("512-wide", wcfg, w_model, w_requests)
    if w_agree < 0.98 * w_frames:
        _fail(f"512-wide: greedy ids agree on {w_agree}/{w_frames} valid frames, below 98 %")

    # BEST-RQ pretraining of the config through cli/pretrain.run: B=16 x 9.3-10 s,
    # codebook 8192, bf16, attention_impl "pallas" (K4 in the steps, K5 in the
    # evaluation), 3 steps and one evaluation batch; then step 1 again with the
    # plain attention
    from huggingface_asr_tpu_torch.cli import pretrain as pretrain_cli
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable, DataConfig
    from huggingface_asr_tpu_torch.training.arguments import (
        GeneralTrainingArguments,
        ModelArguments,
        PretrainingArguments,
    )
    from huggingface_asr_tpu_torch.training.loop import BestRQTrainer

    print("-- BEST-RQ pretraining (cli/pretrain.run): 512-wide config, B=16 x 9.3-10 s, codebook "
          f"{wcfg.best_rq_codebook_size}, bf16, attention_impl 'pallas'", flush=True)
    p_dir = os.path.join(ROOT, "build", "chip_smoke_pretrain")
    shutil.rmtree(p_dir, ignore_errors=True)
    os.makedirs(p_dir)
    with open(os.path.join(ROOT, "configs", WIDE_CONFIG)) as f:
        p_cfg = {**json.load(f), "attention_impl": "pallas"}
    with open(os.path.join(p_dir, "model.json"), "w") as f:
        json.dump(p_cfg, f)

    def p_split(n):
        audio = [speech(rng.uniform(9.3, 10.0), rng) for _ in range(n)]
        return ColumnTable({"audio": audio, "text": [""] * n, "input_len": [len(a) / 16000 for a in audio]})

    p_data = {"train": p_split(16), "validation": p_split(16)}
    p_model_args = ModelArguments(model_config=os.path.join(p_dir, "model.json"), device="cuda", dtype="bfloat16")
    p_training = GeneralTrainingArguments(output_dir=os.path.join(p_dir, "out"), per_device_train_batch_size=16,
                                          per_device_eval_batch_size=16, max_steps=3, logging_steps=1, eval_steps=3,
                                          save_steps=10 ** 9, warmup_steps=1, learning_rate=1e-4, seed=3)
    steps_seen, undo = watch_steps(BestRQTrainer)
    try:
        p_out, p_launches = count_launches(
            lambda: pretrain_cli.run(p_model_args, p_training, PretrainingArguments(), DataConfig(), p_data), {})
    finally:
        undo()
    for i, (_, m, ms) in enumerate(steps_seen):
        print(f"  step {i + 1}: loss={m['loss']:.4f} grad_norm={m['grad_norm']:.3f} applied={int(m['step_applied'])} "
              f"num_masked={int(m['num_masked'])} ({m['percent_masked']:.1f} %) {ms:.1f} ms", flush=True)
    with open(os.path.join(p_dir, "out", "metrics.jsonl")) as f:
        p_eval = [json.loads(line) for line in f if "eval/loss" in line]
    n_l = wcfg.num_hidden_layers
    print(f"  evaluation loss {p_eval[-1]['eval/loss'] if p_eval else None}; launches over the run {p_launches}; "
          f"{smi}", flush=True)
    if len(steps_seen) != 3 or any(int(m["step_applied"]) != 1 or not np.isfinite(m["loss"]) for _, m, _ in steps_seen):
        _fail("BEST-RQ: not every one of 3 steps was applied with a finite loss")
    if not p_eval or not np.isfinite(p_eval[-1]["eval/loss"]):
        _fail("BEST-RQ: no finite evaluation loss")
    want = {"asr_rel_attention_train_fwd": 3 * n_l, "asr_rel_attention_train_bwd": 3 * n_l,
            "asr_rel_attention_shift": n_l, "asr_gemm_bf16": 3 * n_l}
    if any(p_launches.get(k, 0) != v for k, v in want.items()):
        _fail(f"BEST-RQ launches {p_launches}, want {want}")
    if not os.path.exists(os.path.join(p_dir, "out", "final", "pytorch_model.bin")):
        _fail("BEST-RQ: no final/ written")
    # step 1 again from the same initial weights, with the plain attention
    twin = BestRQTrainer(pretrain_cli.build_model(p_model_args, p_training.seed), p_out["trainer"].config,
                         frontend=p_out["trainer"].frontend, device="cuda", dtype="bfloat16")
    model_module.rel_attention_train = rel_attention_train_plain
    try:
        before = dict(_build.LAUNCHES)
        _, m_plain = twin.train_step(twin.init_state(), steps_seen[0][0])
        if dict(_build.LAUNCHES) != before:
            _fail("the plain-attention BEST-RQ step launched an attention kernel")
    finally:
        model_module.rel_attention_train = rel_attention_train
    p_loss = steps_seen[0][1]["loss"]
    d_loss = abs(p_loss - float(m_plain["loss"])) / abs(float(m_plain["loss"]))
    print(f"  BEST-RQ step 1, kernels vs plain attention: loss {p_loss:.6f} vs {float(m_plain['loss']):.6f} "
          f"(rel {d_loss:.2e}, tol 1e-4)", flush=True)
    if d_loss > 1e-4:
        _fail("BEST-RQ step 1 with the attention kernels disagrees with the plain-attention step")
    for k, v in p_launches.items():
        if k.startswith("asr_rel_attention_"):
            wide_launches[k] = v
    del twin, p_out, steps_seen
    torch.cuda.empty_cache()
    fp32_launches, fp32_ft_launches = fp32_wide_phase(dev, smi)
    print(f"512-wide phase: {time.perf_counter() - wide_t0:.1f} s", flush=True)

    ssl_launches = ssl_phase(dev, smi)
    aed_launches = aed_phase(dev, rng, smi)
    aed_train_launches = aed_train_phase(dev, smi)
    cli_launches = cli_phase(dev, smi)
    recipe_launches = recipe_phase(dev, smi)
    variant_launches = variants_phase(dev, smi, compare)
    stats_launches, pg_launches = tools_phase(dev, smi)
    serving_launches, high_launches, gate_counts = serving_phase(dev, smi, compare, ln_gemm_hold, fused, model_dir,
                                                                 requests)
    bins_rows = mel_bins_phase(dev, smi, compare)

    if failures:
        _fail(f"kernel phases outside tolerance: {failures}")

    routes = {
        "mel": ("asr_log_mel", "csrc/mel.cu", "huggingface_asr_tpu/ops/pallas_features.py:112"),
        "cmvn": ("asr_cmvn", "csrc/mel.cu", "huggingface_asr_tpu/ops/pallas_features.py:112"),
        "conv1": ("asr_conv1", "csrc/subsample.cu", "huggingface_asr_tpu/ops/pallas_subsample.py:147"),
        "conv2": ("asr_conv2", "csrc/conv2.cu", "huggingface_asr_tpu/ops/pallas_subsample.py:147"),
        "gemm": ("asr_gemm_bf16", "csrc/gemm.cuh", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "layernorm": ("asr_layernorm_bf16", "csrc/layer.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "gemm_ln": ("asr_gemm_ln_bf16", "csrc/gemm_ln.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "gemm_ln_subsample": ("asr_gemm_ln_bf16", "csrc/gemm_ln.cu", "huggingface_asr_tpu/ops/pallas_subsample.py:147"),
        "pos_query": ("asr_pos_query", "csrc/layer.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "rel_attention": ("asr_rel_attention", "csrc/rel_attention.cu",
                          "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "dwconv_csgu": ("dwconv_csgu", "csrc/dwconv_csgu.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "dwconv_merge": ("dwconv_merge", "csrc/dwconv.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "rel_attention_train_fwd": ("asr_rel_attention_train_fwd", "csrc/rel_attention_train_fwd.cu",
                                    "huggingface_asr_tpu/ops/pallas_train_attention.py:105"),
        "rel_attention_train_bwd": ("asr_rel_attention_train_bwd", "csrc/rel_attention_train_bwd.cu",
                                    "huggingface_asr_tpu/ops/pallas_train_attention.py:130"),
        "rel_attention_shift": ("asr_rel_attention_shift", "csrc/rel_attention_shift_bf16.cu",
                                "huggingface_asr_tpu/ops/pallas_attention.py:34"),
    }
    # the GEMM's readings at M = 32,768 and the convs' at B=128: the same
    # kernel, source and counter
    routes.update({k: routes["gemm"] for k in results if k.startswith("gemm_m32768_")})
    routes.update({k: routes["gemm_ln"] for k in results if k.startswith("gemm_ln_m32768_")})
    routes.update({k: routes[k.rsplit("_", 1)[0]] for k in results
                   if k.endswith("_b128") and k.rsplit("_", 1)[0] in routes})
    launches.update({k: v for k, v in train_launches.items() if k.startswith("asr_rel_attention_")
                     and k != "asr_rel_attention"})
    # the 176-wide entries: launches from its own paths (4 requests; 3 train steps; 1 evaluation step)
    narrow_routes = {
        "layernorm_d176": routes["layernorm"], "gemm_d176": routes["gemm"], "gemm_ln_d176": routes["gemm_ln"],
        "pos_query_dh44": routes["pos_query"],
        "pos_query_dh44_b128": routes["pos_query"],
        "rel_attention_dh44": routes["rel_attention"], "dwconv_csgu_c352": routes["dwconv_csgu"],
        "dwconv_merge_c352": routes["dwconv_merge"],
        "rel_attention_train_fwd_dh44": routes["rel_attention_train_fwd"],
        "rel_attention_train_bwd_dh44": routes["rel_attention_train_bwd"],
        "rel_attention_shift_dh44": routes["rel_attention_shift"],
    }
    # the 512-wide entries: launches from its own paths (4 requests; 3 BEST-RQ steps and 1 evaluation)
    wide_routes = {
        "layernorm_d512": routes["layernorm"], "gemm_d512": routes["gemm"], "gemm_ln_d512": routes["gemm_ln"],
        "pos_query_q512": routes["pos_query"],
        "rel_attention_q512": routes["rel_attention"], "dwconv_csgu_c1024": routes["dwconv_csgu"],
        "dwconv_merge_c1024": routes["dwconv_merge"],
        "rel_attention_train_fwd_q512": routes["rel_attention_train_fwd"],
        "rel_attention_train_bwd_q512": routes["rel_attention_train_bwd"],
        "rel_attention_shift_dh64": routes["rel_attention_shift"],
    }
    # the fp32 kernels (at the flagship's shape and at (dh 64, q_rot 512)): launches from the fp32 BEST-RQ run
    # (3 steps and its "pallas" evaluation batch); the fine-tune's under "fp32_finetune_launches"
    fp32_fwd, fp32_bwd = ((routes[k][0], "csrc/rel_attention_train.cu", routes[k][2])
                          for k in ("rel_attention_train_fwd", "rel_attention_train_bwd"))
    fp32_routes = {
        "rel_attention_train_fwd_fp32": fp32_fwd, "rel_attention_train_bwd_fp32": fp32_bwd,
        "rel_attention_train_fwd_q512_fp32": fp32_fwd, "rel_attention_train_bwd_q512_fp32": fp32_bwd,
        "rel_attention_shift_dh64_fp32": ("asr_rel_attention_shift", "csrc/rel_attention_shift.cu",
                                          routes["rel_attention_shift"][2]),
    }
    fp32_routes["rel_attention_shift_fp32"] = fp32_routes["rel_attention_shift_dh64_fp32"]
    fp32_routes.update(rel_attention_train_fwd_q512_fp32_b32=fp32_routes["rel_attention_train_fwd_q512_fp32"],
                       rel_attention_train_bwd_q512_fp32_b32=fp32_routes["rel_attention_train_bwd_q512_fp32"])
    # the CSGU linear's two pieces: launches from the gated, csgu-linear request of the variants phase
    variant_routes = {
        "dwconv_csgu_conv": ("dwconv_csgu_conv", "csrc/dwconv_csgu.cu", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
        "gemm_gate": ("asr_gemm_gate_bf16", "csrc/gemm.cuh", "huggingface_asr_tpu/ops/pallas_layer.py:417"),
    }
    variant_routes.update(dwconv_csgu_conv_b128=variant_routes["dwconv_csgu_conv"],
                          gemm_gate_m32768=variant_routes["gemm_gate"])
    serving_routes = {
        "mel_bf16": ("asr_log_mel_bf16", "csrc/mel_bf16.cu", routes["mel"][2]),
        "conv1_serving": ("asr_conv1_serving", "csrc/subsample.cu", routes["conv1"][2]),
        "conv2_serving": ("asr_conv2_serving", "csrc/conv2.cu", routes["conv2"][2]),
        "gemm_gelu_serving": ("asr_gemm_ln_gelu_serving", "csrc/gemm_ln.cu", routes["gemm"][2]),
        "rel_attention_serving": ("asr_rel_attention_serving", "csrc/rel_attention.cu", routes["gemm"][2]),
    }
    serving_routes.update(mel_bf16_b128=serving_routes["mel_bf16"], conv1_serving_b128=serving_routes["conv1_serving"],
                          gemm_gelu_serving_m32768=serving_routes["gemm_gelu_serving"])
    # the high mode is on no served route: its launches are a MelFrontEnd(matmul_precision="high") call's
    high_routes = {k: ("asr_log_mel_high", "csrc/mel_bf16.cu", routes["mel"][2]) for k in ("mel_high", "mel_high_b128")}
    # the 23- and 128-bin entries: launches from their own requests (exact for "highest", serving for "bf16",
    # both for cmvn); the 1-11-bin ones ("bf16", "high"): their MelFrontEnd call's, the 10-bin "bf16" its requests'
    src_of = {"asr_log_mel": "csrc/mel.cu", "asr_log_mel_bf16": "csrc/mel_bf16.cu",
              "asr_log_mel_high": "csrc/mel_bf16.cu", "asr_cmvn": "csrc/mel.cu"}
    bins_routes = {k: (counter, src_of[counter], routes["mel"][2]) for k, (counter, _) in bins_rows.items()}
    bins_launches = {k: n for k, (_, n) in bins_rows.items()}
    kernels = []
    for table, counts in ((routes, launches), (narrow_routes, narrow_launches), (wide_routes, wide_launches),
                          (fp32_routes, fp32_launches), (variant_routes, variant_launches),
                          (serving_routes, serving_launches), (high_routes, high_launches)):
        for name, (counter, src, replaces) in table.items():
            kernels.append({
                "name": name, "route": "cuda", "source": f"huggingface_asr_tpu_torch/{src}",
                "replaces": replaces, "launches": counts[counter], **results[name],
                "cli_launches": cli_launches.get(counter, 0),
                "aed_train_launches": aed_train_launches.get(counter, 0),
                "ssl_launches": ssl_launches.get(counter, 0),
                "recipe_launches": recipe_launches.get(counter, 0),
                "stats_cli_launches": stats_launches.get(counter, 0),
                "process_group_launches": pg_launches.get(counter, 0),
            })
    for entry in kernels:
        if entry["name"] in fp32_routes:
            entry["fp32_finetune_launches"] = fp32_ft_launches.get(fp32_routes[entry["name"]][0], 0)
    for name, (counter, src, replaces) in bins_routes.items():
        kernels.append({"name": name, "route": "cuda", "source": f"huggingface_asr_tpu_torch/{src}",
                        "replaces": replaces, "launches": bins_launches[name], **results[name]})
    print(f"AED path launches a request (K2 and K1): {aed_launches}")
    print(f"gate model on the card, id sequences equal to JAX's: {gate_counts}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
