#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # build, kernels, slice, toy, interface, tts_interface,
                                     # xtts, bundle, train, tts_train, xtts_train,
                                     # prosody_train, conditioned, jax_ckpt,
                                     # vocoder_model_train, tts_forward_train, jax_resume,
                                     # tts_options, e2e_train, vocoder_recipes, aligner,
                                     # aux_models, vocoder_cpc, data_prep, annotator,
                                     # ddp, adafactor_zoo
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases toy,interface
    python3 chip_smoke.py --phases tts_interface
    python3 chip_smoke.py --phases build,kernels,xtts,bundle   # XTTS and the entry points
    python3 chip_smoke.py --phases build,train   # GAN training of the flagship vocoder
    python3 chip_smoke.py --phases build,tts_train   # training of the acoustic model
    python3 chip_smoke.py --phases build,xtts_train  # training of XTTS
    python3 chip_smoke.py --phases build,prosody_train,conditioned  # the inference chain
    python3 chip_smoke.py --phases build,jax_ckpt,vocoder_model_train  # JAX checkpoints,
                                     # the Vocos/ISTFT recipe's training
    python3 chip_smoke.py --phases build,tts_forward_train,jax_resume,tts_options
                                     # tts_forward.yml, JAX runs resumed, the kit's options
    python3 chip_smoke.py --phases build,e2e_train,vocoder_recipes,aligner
                                     # E2E GAN-TTS, the vocoder recipes, the aligner
    python3 chip_smoke.py --phases build,aux_models,vocoder_cpc
                                     # the auxiliary models, the vocoder's CPC loss
    python3 chip_smoke.py --phases build,data_prep   # dump, annotation, eval_tts, ...
    python3 chip_smoke.py --phases build,annotator   # corpus preparation, the 5-step
                                     # annotator, the two-stage recipe, MNIST
    python3 chip_smoke.py --phases build,ddp  # data-parallel training on two ranks
    python3 chip_smoke.py --phases build,adafactor_zoo  # adafactor, the loss zoo, MixStyle,
                                     # PreNet, a JAX adafactor run resumed, a pruned
                                     # checkpoint served
    python3 chip_smoke.py --phases profile   # where a flagship batch's time goes

Phases, in order (any failure ends the run with a non-zero exit code):

1. ``gpu``: the card's name and power limit, as ``nvidia-smi`` reports them.
2. ``build``: every CUDA kernel of ``speechflow_torch/csrc`` compiled by
   ``nvcc`` for sm_90a from this checkout (one process per source, in
   parallel), with each command, its time and ``ptxas``' register report,
   and each library's count of ``HGMMA`` (wgmma), ``UTMALDG`` and
   ``UTMASTG`` (TMA load and store) and TF32 tensor-core product
   (``HMMA....F32.TF32``) instructions in its SASS; the attention library
   must have wgmma, TMA loads (its bf16 kernel) and TF32 products (its f32
   kernel).
3. ``kernels``: each kernel wrapper on the card at the shapes the serving
   paths give it (flagship: attention H6 dh128, the anti-alias entries at
   the six head stages; toy: attention H4 dh64, B32 T128 and B32 T1024; the
   XTTS prompt encoder: attention H4 dh256, B 1 and 8, T 1, 17, 112, 128; the prosody
   model: attention H4 dh64, a sentence of 1 to 37 words, a B64 T64 training batch),
   held against its plain PyTorch version on the same inputs (f32 and bf16,
   ragged lengths, T not a multiple of the tile, masks with whole padded key
   and query tiles, narrow heads, f32 rows that are not 16-byte aligned (dh 1
   and 5 at odd H), the validity as the blocks' strided ``mask[:, 0, 0, :]``,
   odd C, large snake arguments, two tap counts), then
   timed beside its plain version, the library call that computes the same
   function where there is one (SDPA for attention, a depthwise ``conv1d``
   for stage 1 of the anti-alias filter), and the bound (the least time the
   card could take, from bytes and operations; f32 attention as three TF32
   products at 495 TFLOP/s). Attention is timed at the rows of
   ``speechflow_torch.tools.attention_times``: the flagship and toy batches
   (bf16), the f32 TTS interface at 32 sentences and the bundle's sentence
   (the serving entry points' f32 default), the XTTS prompt (serving, and the B32
   training batch) and the prosody model (a sentence, a training batch). Tolerances:
   attention f32 5e-5, bf16 1.6e-2; anti-alias f32 1e-5 (of the output's
   scale for large snake arguments), bf16 3.2e-2.
4. ``slice``: the flagship serving path (``serving.build_flagship``, its
   BigVGAN head folded as served) at full width with seeded random weights:
   ``N_BATCHES`` request batches at bench shape (B=32, 128 tokens, 1024 frames, bf16),
   each with 186 attention, 37 fused anti-alias, 6 stage-1 and 18
   snake-downsample launches; the vocoder alone, folded and unfolded, ms a
   batch; one f32 batch of 2 through the kernels and through the plain
   versions (equal durations, then mel and waveform within ``TOL_F32_REL``),
   and its mel through the folded and the unfolded head (within
   ``TOL_F32_REL``); the same gate must reject two planted faults of the
   fold (one dilated conv's folded taps shifted by one, in the first and in
   the last folded stage).
5. ``toy``: the toy serving path (``serving.build_toy``: CFM acoustic model
   256 wide, Vocos with the ISTFT head) at bench shape, bf16: ``N_BATCHES`` batches (the
   first a warm-up), 124 attention launches each (4 encoder + 30 steps x 4
   layers), waveform finite, non-silent, (1024 - 1)·256 samples; one f32
   batch of 2 through the kernels and the plain versions (equal durations,
   then mel and waveform within ``TOL_F32_REL``).
6. ``interface``: ``VocoderEvaluationInterface`` over the flagship BigVGAN
   vocoder (log-mel features, seeded weights, folded as served, f32):
   ``synthesize`` of a (1024, 100) mel and ``resynthesize`` of a 10.9 s
   seeded waveform at 24 kHz (mel on the card; output as long as the input),
   each with 37 / 6 / 18 anti-alias launches; the resynthesis again through
   the plain versions, within ``TOL_F32_REL``.
7. ``tts_interface``: text -> speech at flagship width through the eval
   interfaces: ``TTSEvaluationInterface`` rebuilt from the payload a trainer of
   the flagship stores (``serving.flagship_payload``: the pipeline sections of
   ``configs/tts_data_24khz.yml``, an alphabet of the char fallback's symbols,
   8 speakers, EN/RU) over the seeded acoustic model, and
   ``VocoderEvaluationInterface`` over its BigVGAN vocoder, built once. In
   f32, a request of 2 sentences through the kernels and the plain versions
   (equal durations, then mel and waveform within ``TOL_F32_REL``), and
   ``evaluate`` against the serving program's acoustic model on the same
   inputs and noise (within 1e-6). Then in bf16, a request is a paragraph of
   32 English sentences (a batch of 32, ``t_out`` 1024), composed as the
   export chain composes it: the first speaker, the sentences' valid mel
   frames concatenated, one vocoder call. 1 + ``TTS_REQUESTS`` requests (the first apart):
   each with 186 attention and 37 / 6 / 18 anti-alias launches, every
   utterance's stretch of the waveform finite with std > 1e-4; host frontend,
   acoustic, vocoder and total ms and x realtime over the audio produced. In
   one batch, an SSML sentence with a ``rate="x-slow"`` span must get more
   frames than the same words plain. The phase prints its wall time.
8. ``xtts``: XTTS serving at the recipe's full width (``configs/xtts_model.yml``
   default: GPT 1024 x 12 x 8, prompt encoder 4 blocks of 4 heads of 256, codec
   32 channels at strides 4·8·8, 4 quantizers of 1024), f32, seeded weights (flax's
   initialisers) written by the port's saver with the text pipe of
   ``configs/tts_data_24khz.yml`` and loaded by ``XTTSEvaluationInterface``: one
   greedy request of ``XTTS_GREEDY_TOKENS`` tokens through the kernels and the plain versions
   (prompt embeddings and prefill logits within ``TOL_F32_REL``, then the first
   differing token, if any, with its top-2 logit margin); ``XTTS_REQUESTS`` text requests of 512
   tokens at temperature 0.8 behind a 448-frame synthetic reference prompt (4
   attention launches each, finite waveforms of 512 hops); ms a request (first,
   median), x realtime, the ms a decoded token (a 512-token and a 1-token
   generate on the same inputs and seed, the difference over 511) beside the
   per-token bound (trunk weights and KV cache over HBM), the request's stages
   (host frontend, prompt encoder, prefill, decode, codec decode) against the
   median request, a 17-token request under ``torch.profiler`` (busy share, kernels a
   decode step), peak memory, and a batch of ``XTTS_BATCH`` through ``XTTSModel.synthesize``
   (tokens a second).
9. ``bundle``: the serving entry points. Port checkpoints of the flagship acoustic
   model and BigVGAN vocoder (seeded) and the XTTS model above, ``pack``ed
   and ``InferenceBundle.load``ed on the card (f32): ``bundle.synthesize`` of a
   sentence (the first call, then three warm ones after the path's launch counts
   are read) and ``bundle.xtts.synthesize`` of one (128 tokens, with the prompt),
   then ``app.demo_server.make_server`` on a free port in a thread answers ``/``,
   ``/info``, two ``/synthesize`` (a WAV at 24 kHz, mono, 16 bit, as long as each
   sentence's frames through the vocoder) and a 404; the attention and the three
   anti-alias entries must launch. Then, at the shapes these paths give the
   kernels, through the kernels and the plain versions from one seed:
   ``bundle.synthesize`` of that sentence (``t_out`` 1024, one vocoder call) and
   the demo server's chain on its first request (``t_out`` 512, a vocoder call a
   sentence): equal lengths, mel and waveforms within ``TOL_F32_REL``.
10. ``train``: GAN training of the flagship BigVGAN vocoder
   (``configs/vocoder_bigvgan.yml`` default: the unfolded head, 1536 channels,
   MPD + sub-band CQT discriminators, batch 32 of 1.0 s chunks, grad_accum 8,
   bf16 autocast, AdamW on WarmupCosine) through the port's entry point
   ``scripts.train_vocoder.train`` on ``tests/data/SEGS``. First the
   anti-alias VJPs (the autograd Functions) against PyTorch autograd of the
   plain versions at the head's training stage shapes, f32 (``TOL_F32_REL``)
   and bf16 (1.6e-2 of the plain gradient's largest magnitude), and their time
   at B=32 beside the forward kernels'. Then one f32 GAN micro-batch at
   flagship width (B=2, 8192 samples) through the kernels and the plain
   versions: generator losses, discriminator loss and every parameter's
   gradient within ``TOL_F32_REL``; the same gate must reject a planted fault
   (dβ negated in one snake). Then 16 micro-batches (2 optimizer steps) into a
   temporary experiment directory: finite losses; the generator unchanged
   after micro-batches 1-15 and changed after the 16th (the first optimizer
   step, at the 8th, runs at the schedule's lr of 0 at count 0, as optax's
   warmup does: it must advance the optimizer's count and moments and leave
   the weights); the discriminator untouched by every generator step; 37 / 6
   / 18 anti-alias forward launches and 37 / 6 / 18 VJP kernel launches per
   micro-batch (the fused VJP recomputes stage 1 in its registers). Prints ms per micro-batch and
   per optimizer step, seconds of audio trained per second, peak device
   memory, the VJPs' share and the phase's wall time. Last, the checkpoint it
   wrote goes through ``ExperimentSaver.load_checkpoint`` ->
   ``VocoderEvaluationInterface.from_checkpoint`` -> ``resynthesize`` of a
   SEGS utterance: finite, as long as the input, and within ``TOL_F32_REL`` of
   the trained generator's own f32 output.
11. ``tts_train``: training of the flagship acoustic model
   (``configs/tts_model.yml`` default: 768 x 6 x 6, CFM decoder, dropout 0.1,
   AdamW on WarmupCosine, clip 1.0, f32 with TF32 off) through the port's
   entry point ``scripts.train_tts.train`` on ``tests/data/SEGS``
   (``configs/tts_data_24khz.yml``: 40 train utterances, so the batch of 48
   is the whole split, 4 DataLoader workers). First one f32 step at full
   width on the card and on the CPU (the same seeded random weights, dropout
   0, two utterances, injected u, z and CFG masks, the CPU's ReLU masks): no
   reference gradient all zero but the attention key biases', losses within
   ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD`` of its scale; the
   same gate must reject a planted fault (the CFM prior ``mu`` not
   detached). Then ``TTS_TRAIN_STEPS`` steps
   into a temporary experiment directory: finite losses; the weights
   unchanged after step 1 (lr 0 at count 0) and changed after step 2; no
   fused-attention launch (training takes the plain attention). Prints ms
   per step inside the step and between steps, mel frames trained per
   second, peak device memory and the step's FLOP bound. Last, the
   checkpoint through ``ExperimentSaver.load_checkpoint`` ->
   ``TTSEvaluationInterface.from_checkpoint``, which must find the ``g2p.pkl`` that
   ``train_tts`` trained into the experiment (1200 steps x 3 members) and phonemize
   the request through it: in f32, through the kernels,
   within ``TOL_F32_REL`` of the trained model through the plain versions on
   a text request (mel and waveform), and the vocoder's kernels within it of
   its plain versions on a training utterance; then in bf16 a
   request of 4 sentences with 186 / 37 / 6 / 18 launches through the
   seeded flagship vocoder's interface, the waveform finite and as long as
   its frames.
12. ``xtts_train``: training of XTTS (``configs/xtts_model.yml`` default: GPT 1024 x
   12 x 8, a prompt encoder of 4 blocks of 4 heads of 256, the codec 32 channels at
   strides 4·8·8 with 4 quantizers of 1024, batch 32, AdamW on WarmupCosine, clip 1.0,
   f32 with TF32 off, flax's initialisers) through the port's entry point
   ``scripts.train_tts.train`` on ``tests/data/SEGS`` (``configs/tts_data_24khz.yml``,
   the collate swapped to ``TTSCollateWithPrompt``, the recipe's 2 DataLoader
   workers). First the fused-attention autograd Function at the path's shape (B32 T112
   H4 dh256, f32, ragged, 1e4 in padded rows): one forward launch, the VJP's gradients
   against PyTorch autograd of the plain version within ``TOL_VJP_F32``, and the
   forward's, the VJP's and the plain backward's ms. Then one f32 step at full width on
   the card and on the CPU (the same weights, the first two train utterances, the
   CPU's codes given to both, the card's own code flips counted): no reference
   gradient all zero but the codec's, ``gpt_ce`` within ``TOL_F32_REL``, every
   gradient within ``TOL_TTS_GRAD`` of its scale; the same gate must reject a planted
   fault (the VJP's dq and dk exchanged). Then ``XTTS_TRAIN_STEPS`` steps into a
   temporary experiment directory: lr 0 at count 0, finite losses, the weights
   unchanged after step 1 and changed after step 2, 4 fused-attention launches a
   step. Prints ms per step inside the step and between steps, audio tokens trained
   per second, peak device memory, the step's FLOP bound, the attention's forward and
   VJP ms a step and the phase's wall time. Last, the checkpoint through ``XTTSEvaluationInterface``: a
   greedy request kernels vs plain (as in ``xtts``), then a request of 128 tokens
   with 4 attention launches and a finite waveform.
13. ``prosody_train``: the prosody model (``configs/prosody_model.yml`` default: 256
   x 4 layers x 4 heads, vocab 8000, batch 64, ``tokenizer: word_lm``) through the
   port's ``scripts.train_prosody.train`` on ``tests/data/SEGS`` for
   ``PROSODY_TRAIN_STEPS`` steps. First one f32 step of the preset's model (seeded,
   dropout 0) on the card and on the CPU on one SEGS batch: losses within
   ``TOL_F32_REL``, every gradient within ``TOL_PROSODY_GRAD`` of its scale. Then
   the run: the WordLM trained on the card, finite losses, 4 attention launches a step
   (the JAX trainer's call is the model's deterministic one, so the blocks attend
   through the kernel and its VJP). Prints the WordLM's seconds, ms a step, words
   trained a second and peak memory. Last, the checkpoint through
   ``ProsodyPredictionInterface`` on the card: 8 request sentences through the
   kernels and the plain versions, logits within ``TOL_F32_REL`` and the same
   classes, 4 launches a sentence, ms a sentence.
14. ``conditioned``: the reference's inference chain. The flagship acoustic model at
   full width with ``use_prosody``, ``speaker_emb_mode: input`` (192 wide) and the
   style VAE, f32 from flax's initialisers (the duration predictor's output bias at
   log(1 + 8) frames a token, as in ``bundle``), behind ``TTSEvaluationInterface``
   with the prosody checkpoint of ``prosody_train`` (else a fresh one), the payload's
   ``MeanBioEmbeddings`` fitted over the SEGS train split through
   ``voice_biometrics``, and a seeded ECAPA at default width (80 mels, 256 channels,
   192 dims, 3 blocks) saved with ``save_module`` and set through
   ``set_biometric_model(make_ecapa_hook(...))`` on the card; the flagship vocoder.
   Gates: the ECAPA embedding of LJ001-0002.wav on the card against the CPU's
   (``TOL_ECAPA``); a request of 8 sentences with that reference through the kernels
   and the plain versions on the same inputs and noise (equal durations, mel and
   waveform within ``TOL_F32_REL``); 1 + ``COND_REQUESTS`` requests, each with 186 + 4 x 8 attention
   and 37 / 6 / 18 anti-alias launches and finite, non-silent utterances; and
   ``resynthesize`` of a SEGS utterance with the reference (186 / 37 / 6 / 18 launches,
   t_out the source's frames, a finite, non-silent waveform). Prints each request's
   stages (ECAPA, the host's reference work: wav load and style mel, prosody
   prediction, the rest of the host frontend, acoustic model, vocoder), the first and
   the median request, x realtime and the ms of ``resynthesize``. Then a GMVAE style
   encoder at the model's style width: ``sample_prior`` on the card against the CPU on
   the same component indices and normals (``TOL_PRIOR`` of scale), and from a card
   generator alone.
15. ``jax_ckpt``: the checkpoints ``tests/make_jax_checkpoints.py`` wrote with the JAX
   package (``tests/data/jax_checkpoints``: the debug TTS recipe and the debug BigVGAN
   vocoder, 2 steps each; orbax OCDBT with zstd zarr chunks) read on the card's host
   without JAX (each one's bytes and read ms), into ``TTSEvaluationInterface`` and
   ``VocoderEvaluationInterface`` in f32; the recorded sentence with the recorded
   durations injected through both kernels (launches counted): mel and waveform
   against the JAX package's within ``TOL_JAX_MEL`` and ``TOL_JAX_WAV`` of the
   reference's scale, and against the plain versions within ``TOL_F32_REL``; then an
   ``InferenceBundle`` packed from the two experiment directories serves the sentence
   with the same launches and waveform.
16. ``vocoder_model_train``: ``configs/vocoder_model.yml`` at its default width (mel
   features, Vocos 512 x 8, ISTFT head, MPD + MRD at 32 channels, batch 32 of 1.0 s
   chunks, f32) read by the YAML reader and trained through ``train_vocoder.train`` on
   ``tests/data/SEGS``; cut: ``VOCODER_MODEL_STEPS`` steps. Finite losses; prints ms a
   step, audio seconds trained a second and peak memory; the checkpoint through the
   vocoder interface against the trained generator (``TOL_F32_REL``). The ISTFT head
   launches no hand kernel.
17. ``tts_forward_train``: ``configs/tts_forward.yml`` at its default width (bi-GRU
   encoder and wrapper decoder 256 wide, pitch and energy bucketed and embedded,
   batch 48: the 40 train utterances of SEGS, mixed precision as the file says) through
   ``train_tts.train``; cut: ``TTS_FORWARD_STEPS`` steps. First one f32 step card vs CPU
   (flax's initialisers, dropout 0, two utterances, the CPU's ReLU masks): losses within
   ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD``, a planted fault (the
   decoder's backward GRU run forward) rejected. Then the run: finite losses, the
   weights unchanged after step 1 and changed after step 2; ms a step, mel frames a
   second, peak memory; the decoder's bi-GRU at ``GRU_TIMED`` and ``maximum_path`` at
   ``MAS_TIMED``. Last, the checkpoint through ``TTSEvaluationInterface`` and the
   flagship BigVGAN's interface: 4 sentences, 37 / 6 / 18 anti-alias launches and no
   attention, the waveform kernels vs plain within ``TOL_F32_REL``.
18. ``jax_resume``: the JAX runs of ``tests/data/jax_checkpoints/resume`` (the debug
   ``tts_forward.yml`` and ``vocoder_model.yml`` recipes, narrowed, with optax state)
   resumed as ``-r`` resumes them, every dropout rate 0, one step each on the recorded
   batch: losses within ``TOL_F32_REL`` of JAX's next step, the recorded samples of the
   parameters within two Adam steps and of both moments within ``TOL_RESUME_MOMENT``
   of the model's scale (``resume_record.npz``).
19. ``tts_options``: ``TTS_OPTIONS`` (a multi-stream context encoder of a conformer and
   a transformer, the variance options, averages, the inverse speaker classifier, the
   Tacotron decoder) at width 256, f32: a training step (finite losses and gradients,
   no attention launch), then an inference call with 8 attention launches, kernels vs
   plain within ``TOL_F32_REL``.
20. ``e2e_train``: ``configs/vocoder_styletts2_e2e.yml`` at its default width (the acoustic
   model 256 wide, 4 + 4 transformer layers, inside Vocos 512 x 8 with the NSF-HiFiGAN head,
   256 channels, style 192; batch 16 of ``configs/tts_data_24khz.yml``, f32) through
   ``train_vocoder.train``; cut: ``E2E_STEPS`` steps. First one f32 generator step card vs
   CPU (flax's initialisers, dropout 0, two utterances, the same sine draws, the ReLUs
   and the NSF head's leaky ReLUs pinned, the adversarial terms off): losses within
   ``TOL_F32_REL``, the gradients of a fixed waveform cotangent plus the extractor's
   losses within ``TOL_TTS_GRAD``, a planted fault (a transposed conv's kernel flipped)
   rejected. Then
   the run (ms a step, audio seconds a second, peak memory); the checkpoint through
   ``VocoderEvaluationInterface`` on a text batch of 4 test utterances with no mel (4
   frames a token injected): one fused-attention launch a transformer layer (dh 64),
   kernels vs plain within ``TOL_F32_REL``; then by layer (``e2e_serve_layers``): the
   acoustic model's mel and frame F0 within ``TOL_F32_REL``, and the waveform vocoded with
   the F0 held at the plain run's within ``TOL_F32_REL``. Then
   ``vocoder_styletts2_e2e_ft.yml`` (the BigVGAN head) for ``E2E_FT_STEPS`` steps with
   ``warmstart.disc_from`` the E2E run: its anti-alias launches and VJPs a step; its
   trained generator through the kernels and the plain versions on one f32 step
   (``ft_kernel_gate``): the waveform and losses within ``TOL_F32_REL``, the gradients
   within ``TOL_TTS_GRAD``, two planted faults of the VJP (dβ negated in every snake, dx in
   the post snake) rejected.
21. ``vocoder_recipes``: ``vocoder_nsf.yml`` + ``vocoder_nsf_data_24khz.yml`` default (its
   f32 generator gate and planted fault as in ``e2e_train``; ``NSF_STEPS`` micro-batches),
   served through ``VocoderEvaluationInterface`` (``synthesize`` with a TTS output's F0,
   ``resynthesize`` with the host's YIN F0); ``nsf_istft`` inference card vs CPU;
   ``vocoder_mel_dac.yml`` default (``DAC_STEPS`` steps) and ``resynthesize``; the IMDCT
   (both) and DAC heads at dim 512, a GAN micro-batch and an inference call card vs CPU
   each; a GAN step with ``bio_ckpt`` (a seeded ECAPA); ``train_mos_proxy`` for
   ``MOS_STEPS`` steps hooked into a GAN validation. No hand kernel runs on these paths.
22. ``aligner``: ``configs/aligner_model.yml`` default (192 wide, 4 layers of 2 heads of 96,
   6 flows) on ``aligner_data_stage1.yml`` over the raw ``.TextGrid`` of a copy of SEGS:
   one f32 step card vs CPU (seeded, dropout 0, the CPU's path pinned, the card's own path
   equal to it with TF32 off; the durations moved with TF32 on counted; a planted fault,
   the squeeze by halves, rejected); ``ALIGNER_STEPS`` steps; the annotator's ``Aligner``
   writes ``.TextGridStage1`` (dh-96 attention, kernels vs plain); every grid read back with
   ``AudioSeg.load``. Prints ms a step, mel frames a second, ms an aligned utterance. Stage
   2 and the correction run in ``annotator``, through the runner, at the same width.
23. ``aux_models``: the auxiliary models at their JAX defaults on the card, TF32 off. G2P:
   ``train_g2p_artifact`` on SEGS (1200 steps x 3 BiGRU members, each member's steps a
   replayed CUDA graph), tests/test_g2p.py's 25 held-out word types scored (PER <= 0.31,
   exact-match >= 0.26), then 4 raw-text sentences through ``TTSEvaluationInterface`` at
   flagship width that finds the ``g2p.pkl`` (its tokens the G2P's phonemes; 186 / 37 / 6
   / 18 launches). CREPE: ``train_crepe`` (``CREPE_STEPS`` x 64), held tones' median relative error
   < 0.03, the ``pitch`` handler's ``crepe`` and ``yingram`` on a SEGS utterance. CTC:
   tests/test_asr_ctc.py's synthetic task until greedy decoding returns the sequences,
   then ``CTCPhonemeASR`` over the saved checkpoint (45 s, three windows). Demucs:
   ``DEMUCS_STEPS`` steps under ``denoiser_criterion``, the ``denoise`` handler over the
   checkpoint. CPC: ``train_cpc`` on the SEGS waves (the loss falling), saved and read
   back by ``ssl_features``. The codec and ECAPA examples for a few steps, each pickle
   read by its handler. One f32 step of CPC, CREPE, CTC and demucs card vs CPU: the loss
   within ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD`` of its scale.
24. ``vocoder_cpc``: ``configs/vocoder_bigvgan.yml`` default (the unfolded 1536 head) with
   ``loss.cpc_ckpt`` the CPC of ``aux_models`` (else one trained for 20 steps). First the
   f32 gate (``cpc_gate``): a GAN micro-batch B2 x 8192 through the kernels and the plain
   versions, the losses (``cpc`` among them) within ``TOL_F32_REL``, every gradient within
   ``TOL_GAN_GRAD``, and the ``cpc`` term's own generator gradients within
   ``TOL_GAN_GRAD``; a planted fault (the fake branch detached) rejected. Then
   ``train_vocoder.train`` for ``CPC_MICRO_BATCHES`` micro-batches: finite losses, the
   CPC's weights unchanged, 37 / 6 / 18 anti-alias launches forward and 37 / 6 / 18 VJP each. Then
   the checkpoint through ``VocoderEvaluationInterface`` (folded) and ``Denoiser`` over its
   model: the bias and a resynthesis (37 / 6 / 18 launches each), denoised, kernels vs
   plain within ``TOL_F32_REL``.
25. ``data_prep``: the data-preparation chain on a copy of SEGS. ``dump.main`` over
   ``configs/tts_data_24khz.yml`` at its default select with ``CONTOUR_HANDLERS`` before
   aggregate_pitch (the whole corpus, the feature cache on), twice: ms an utterance on
   the first and on the cached pass, the cache's hits (every handler of the second
   pass). A data server, 2 workers and a loader from a config path
   (``init_data_loader(config_path=..., value_select=["debug"])`` over
   ``configs/tts_data_24khz.yml``): 2 batches equal to the same pipeline's in-process
   ones. ``prosody_annotation.main`` from that dump (the share of words labelled),
   ``train_prosody`` default on those labels for ``DATA_PREP_PROSODY_STEPS`` steps (4
   attention launches a step, f32). ``train_tts`` with ``configs/tts_model.yml`` default
   (768 x 6 x 6, CFM-DiT, f32) for ``DATA_PREP_TTS_STEPS`` steps over the dump's cache,
   normalising pitch and energy by speaker from its ``ranges.json`` (``UPDATE_HANDLERS``
   recomputed): the collated averages present and finite, ms in and between steps,
   peak memory. ``eval_tts.main`` on that checkpoint and a seeded BigVGAN checkpoint:
   186 / 37 / 6 / 18 launches a text, finite non-silent ``.wav`` files of 256 samples a
   mel frame after the first; one sentence kernels vs plain (f32, mel and the 16-bit wav within
   ``TOL_F32_REL``). ``configs/vocoder_bigvgan.yml`` default (bf16) for
   ``DATA_PREP_VOC_MICRO_BATCHES`` micro-batches without and with
   ``VOC_AUGMENTATIONS`` (37 / 6 / 18 launches forward and VJP each): ms between micro-batches.
   ``data_pipeline_check.main --profile`` over the TTS config with every new handler
   (``CHECK_AFTER``): the contracts, each handler's host ms. The Ogg fixtures, where
   ctypes finds the codec libraries (which it found is printed).
26. ``annotator``: on a copy of ``tests/data/SRC``, ``prepare_datasets.main`` for the
   LJSpeech layout and for a golos layout of 4 SRC wavs (each to ``GOLOS_DBFS``), and
   hifi_tts's Ogg conversion where the codec libraries are found (else printed as not
   run). ``annotator.runner.main -vs default`` (``aligner_model.yml``: 192 wide, 4 layers
   of 2 heads of 96, 6 flows; f32, TF32 off) over the copy: steps 0-1 (ms a seg, host),
   then steps 2-4 with ``--max_steps ANNOTATOR_STEPS`` (ms a training step and an aligned
   utterance a stage; the launches of these steps are the path's); sidecars, segs, every
   stage's grids read back, the speakers; stage 2 warm-started from stage 1. Then a batch
   of the stage-3 grids through the kernels and the plain versions (durations equal, the
   rest within ``TOL_F32_REL``). The two-stage recipe on the tone corpus of
   ``tests/test_annotator_two_stage.py`` (debug width, ``TONE_STEPS`` a stage) under that
   test's assertions, and the MNIST example (``MNIST_STEPS`` of B``MNIST_BATCH``;
   accuracy above 0.8, as JAX's example requires).
27. ``ddp``: data-parallel training on ``DDP_WORLD`` ranks of the one card (forks of
   the worker forkserver, ``concurrency.context``) under the environment contract
   (``SPEECHFLOW_COORDINATOR``, ``_NUM_PROCESSES``, ``_PROCESS_ID``) with gloo
   (collectives time out after ``DDP_COLLECTIVE_S``), rank 0's data server feeding both:
   ``train_tts.train`` on ``configs/tts_model.yml`` default with ``use_mesh`` (global
   batch ``DDP_TTS_BATCH``, ``DDP_TTS_STEPS`` steps), then ``train_vocoder.train`` on the
   train phase's recipe (``DDP_GAN_MICRO_BATCHES``, one optimizer step, each micro-batch
   split over the ranks). Before its first step each rank
   takes its gradients on seeded random weights (dropout off, injected draws), averaged over
   the ranks, and rank 0 holds them against one process on the gathered global batch (the
   ReLUs' sides pinned; ``TOL_TTS_GRAD``), as it holds the gradients with each rank's own
   valid-frame count as the normaliser, which must be rejected; the GAN's gate:
   ``GANTrainer``'s own ``use_mesh`` step in float64 through the plain versions on
   ``DDP_GATE_WAVE`` of each rank's rows (SGD at lr 1; kinks pinned) against one
   process's updates within ``TOL_DDP_F64``, two planted faults (a rank that skips the
   all-reduce; the STFT loss's spectral convergence of the rank's own norms) rejected.
   Then: each step's
   samples disjoint over the ranks and together one process's global batch, the weights
   equal on both ranks, rank 0's experiment the only one, its checkpoint served one request
   through ``TTSEvaluationInterface`` kernels vs plain (186 / 37 / 6 / 18 launches), the
   anti-alias kernels and VJPs launched in each rank; ms a step, the loader's wait and peak
   memory per rank; no child process left.
28. ``adafactor_zoo``: the rest of the training API. ``train_tts.train`` on a copy of
   ``configs/tts_model.yml`` with ``optimizer.method: adafactor``, read as ``-c`` reads
   it (default preset: 768 wide, 6 + 6 layers, CFM, f32), ``ADAFACTOR_BATCH`` of the SEGS
   train utterances, ``ADAFACTOR_STEPS`` steps, under ``DATAPIPE_PROFILING=1`` inside the
   experiment's ``LoggingServer``: finite losses, the weights unchanged after step 1 (lr 0)
   and changed after step 2, the server's profiler summary with every handler of the
   recipe's pipeline once a sample the workers processed; ms a step, peak memory, the
   optimizer state's bytes against Adam's, the factored leaves. The recipe's chain
   (clip, adafactor, windows) over the full-width model from seeded gradients, card f32
   against CPU float64, ``ADAFACTOR_UPDATES`` updates within ``TOL_F32_REL`` of each
   tensor's largest, and a planted fault (no 1e-3 floor of the parameter scale: the
   zero-initialised modulations never move) rejected. The committed JAX adafactor run
   (``tests/data/jax_checkpoints/resume_adafactor``) resumed as ``-r`` resumes it: JAX's
   next step's losses within ``TOL_F32_REL``, its sampled ``v_row`` / ``v_col`` / ``v``
   within ``TOL_RESUME_MOMENT`` of their scale, and a planted fault (factored axes from
   the torch shape) rejected. The loss zoo's eight new losses at a recipe's shapes
   (``ZOO_SHAPES``), value and gradient, card f32 against CPU float64 (``TOL_F32_REL``,
   ``TOL_ZOO_GRAD``), the soft-DTW timed forward and backward and its planted fault (the
   diagonal dropped from the soft-min) rejected; ``MixStyle`` and ``PreNet`` card vs CPU.
   The run's checkpoint pruned (``utils.misc.prune_checkpoint``: smaller on disk) and
   served through ``TTSEvaluationInterface`` and the flagship BigVGAN's interface, f32:
   ``ADAFACTOR_SENTENCES``, 186 / 37 / 6 / 18 launches, the waveform kernels vs plain
   within ``TOL_F32_REL``, and equal to the full checkpoint's.
29. ``profile`` (only when asked for): for the flagship and the toy program,
   one batch timed model by model, and one under ``torch.profiler``, with
   device time by kernel family and the device's busy share.

After each phase a line ``[time] <phase> <seconds> s``, and ``[time] total`` before the
``kernels`` line. Past ``SMOKE_DEADLINE_S`` a watchdog (``faulthandler``) prints every
thread's stack and exits with code 1.

``TOL_F32_REL`` is relative: an f32 output through the kernels may differ
from the plain versions' by 1e-4 of the plain output's largest magnitude
(the flagship waveform's per-utterance std is ~1e-3, so an absolute limit
would not see a fault of the head).

Each path's launch counts are set to 0 just before it runs and read just
after, and every kernel of the path must have launched. The line before the
last is one JSON object with a record per kernel: ``launches`` sums the
paths' runs (``launches_by_path`` splits them); ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are those of one flagship batch of launches,
and attention, which the toy program also launches, has each program's
beside them (``ms_by_path``, ``bound_ms_by_path``, ...). The last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import functools
import json
import os
import shutil
import subprocess
import sys
import time
import typing as tp
import urllib.parse
from pathlib import Path

REPO = Path(__file__).resolve().parent
SMOKE_DEADLINE_S = 1100  # the watchdog: past it the run fails with every thread's stack

# H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12}
SR, HOP = 24000, 256
BATCH, T_FRAMES = 32, 1024  # the bench request shape (serving.bench_inputs: 128 tokens)
N_BATCHES = 2  # request batches of a serving path; the first is timed apart as warm-up
# f32 outputs of a path through the kernels against the plain versions (and the folded
# head against the unfolded one): a share of the reference's largest magnitude
TOL_F32_REL = 1e-4

# flagship per-batch launches (encoder 6 + CFM 30 steps x 6 layers; BigVGAN head:
# 6 stages x 3 MRF branches x 3 activations, first of each branch from the shared
# stage-1 FIR, plus the post activation)
HEAD_LAUNCHES = {"anti_alias_snake": 6 * 3 * 2 + 1, "aa_upsample_fir": 6,
                 "aa_snake_downsample": 6 * 3}
EXPECTED_LAUNCHES = {"fused_attention": 6 + 30 * 6, **HEAD_LAUNCHES}
# toy per-batch launches: encoder 4 + CFM 30 steps x 4 layers (no CFG); ISTFT head
TOY_LAUNCHES = {"fused_attention": 4 + 30 * 4, "anti_alias_snake": 0, "aa_upsample_fir": 0,
                "aa_snake_downsample": 0}
# a training micro-batch of the flagship vocoder recipe: the forward's 37 / 6 / 18, and a
# VJP kernel of each (the fused one recomputes its stage 1 in registers)
TRAIN_LAUNCHES = {"fused_attention": 0, "anti_alias_snake": 37, "aa_upsample_fir": 6,
                  "aa_snake_downsample": 18}
TRAIN_VJP_LAUNCHES = {"anti_alias_snake_vjp": 37, "aa_upsample_fir_vjp": 6,
                      "aa_snake_downsample_vjp": 18}
TRAIN_PRESET = "default"
TRAIN_MICRO_BATCHES = 16  # 2 optimizer steps at grad_accum 8
TRAIN_FRAMES = 24064 // HOP + 1  # a 1.0 s chunk padded to 94 hops: 95 mel frames
TRAIN_STAGES = [(TRAIN_FRAMES * r, c) for r, c in
                ((4, 768), (16, 384), (32, 192), (64, 96), (128, 48), (256, 24))]
TOL_BF16_GRAD = 1.6e-2  # bf16 gradients: of the plain gradient's largest magnitude
TOL_GAN_GRAD = 1e-2  # a whole f32 GAN micro-batch's gradients (see gan_gate)
# wgmma, TMA load and store (the bf16 attention, the anti-alias kernels), and TF32
# tensor-core products (mma.sync or wgmma: the f32 attention)
SASS_OPCODES = {"HGMMA": "HGMMA", "UTMALDG": "UTMALDG", "UTMASTG": "UTMASTG",
                "TF32 MMA": r"H(?:G)?MMA\.\w+\.F32\.TF32"}
HEAD_STAGES = [(4096, 768), (16384, 384), (32768, 192), (65536, 96), (131072, 48),
               (262144, 24)]
# XTTS (configs/xtts_model.yml default): a request decodes 512 tokens (256 samples each,
# 5.46 s at 24 kHz) behind a reference prompt of 448 mel frames, which the prompt
# encoder's stride 4 makes 112; its 4 blocks attend with 4 heads of 256
XTTS_MAX_TOKENS, XTTS_PROMPT_FRAMES, XTTS_REQUESTS, XTTS_BATCH = 512, 448, 2, 2
XTTS_GREEDY_TOKENS = 64  # the kernels-vs-plain request (two of them: keep it short)
XTTS_DECODE_RUNS = 1  # generates of 512 and of 1 token that time the decode
# the kernel's dh-256 cases: (B, T, lengths) at B 1 and 8, ragged
XTTS_PROMPT_CASES = [(b, t, [max(1, t - 13 * i) for i in range(b)])
                     for t in (1, 17, 112, 128) for b in (1, 8)]
XTTS_LAUNCHES = {"fused_attention": 4, "anti_alias_snake": 0, "aa_upsample_fir": 0,
                 "aa_snake_downsample": 0}
BUNDLE_XTTS_TOKENS = 128
KERNEL_META = {
    "fused_attention": ("speechflow_torch/csrc/attention.cu",
                        "speechflow_tpu/ops/attention.py:111"),
    "anti_alias_snake": ("speechflow_torch/csrc/anti_alias.cu",
                         "speechflow_tpu/ops/anti_alias.py:194"),
    "aa_upsample_fir": ("speechflow_torch/csrc/anti_alias.cu",
                        "speechflow_tpu/ops/anti_alias.py:194"),
    "aa_snake_downsample": ("speechflow_torch/csrc/anti_alias.cu",
                            "speechflow_tpu/ops/anti_alias.py:194"),
}


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, op_type: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1/2 -------------------------------------------------------------------


def phase_gpu() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build() -> None:
    from speechflow_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    for name, r in report.items():
        print(f"[build] {name}: {r['cmd'] or 'cached'}  ({r['seconds']:.1f} s)")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.sources():
        counts = _build.sass_counts(name, SASS_OPCODES)
        print(f"[build] {name} SASS: " + ", ".join(f"{op} {n}" for op, n in counts.items()),
              flush=True)
        if name == "attention":
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0 and counts["TF32 MMA"] > 0,
                  f"the attention library lacks wgmma, TMA loads or TF32 tensor-core "
                  f"products in its SASS: {counts}")


# -- phase 3 ---------------------------------------------------------------------


def _attention_cases():
    # (label, B, T, H, dh, lengths, masked key ranges (row, start, stop)): encoder and
    # CFM (CFG-doubled) shapes of the flagship path, T not a multiple of the 128-row
    # tile, masks with whole padded key tiles (in the middle, first), the bundle's one
    # sentence (most key and query tiles padded), narrow heads, f32 rows that are not
    # 16-byte aligned (dh 1 and 5 at odd H: no bf16 case, which needs dh % 8 == 0)
    yield "encoder", 32, 128, 6, 128, [128] * 31 + [77], []
    yield "cfm", 64, 1024, 6, 128, [1024 - 37 * (i % 9) for i in range(64)], []
    yield "ragged-T", 4, 1000, 6, 128, [1000, 999, 513, 1], []
    yield "masked-tiles", 2, 1000, 2, 64, [1000, 1000], [(0, 256, 384), (1, 0, 128)]
    yield "bundle-cfm", 2, 1024, 6, 128, [297, 297], [(0, 64, 192)]
    yield "dh40", 2, 129, 3, 40, [129, 1], []
    yield "dh5", 2, 77, 3, 5, [77, 30], []
    yield "dh1", 2, 33, 5, 1, [33, 2], []
    # the toy program's shapes: 4 heads of 64
    yield "toy-encoder", 32, 128, 4, 64, [128] * 30 + [77, 5], []
    yield "toy-cfm", 32, 1024, 4, 64, [1024 - 37 * (i % 9) for i in range(32)], []
    # the XTTS prompt encoder: 4 heads of 256 (the TF32 kernel), B 1 and 8, ragged
    for b, t, lens in XTTS_PROMPT_CASES:
        yield f"xtts-prompt-T{t}", b, t, 4, 256, lens, []
    # the prosody model: one sentence padded to 16 tokens (1, 10 and 16 words valid), and
    # a training batch of the default preset (64 rows of 64 word slots, ragged)
    for words in (1, 10, 16):
        yield f"prosody-w{words}", 1, 16, 4, 64, [words], []
    yield "prosody-w37", 1, 48, 4, 64, [37], []
    yield "prosody-train", 64, 64, 4, 64, [max(1, 40 - 2 * (i % 16)) for i in range(64)], []


def _strided(torch, valid):
    """The key validity as a strided view, which the kernels read in place: the blocks'
    ``mask[:, 0, 0, :]`` (row stride T * T) where every row's first key is valid, as on
    the paths, else the first T columns of a wider tensor."""
    if bool(valid[:, 0].all()):
        return (valid[:, None, None, :] & valid[:, None, :, None])[:, 0, 0, :]
    wide = torch.zeros(valid.shape[0], valid.shape[1] + 5, dtype=torch.bool,
                       device=valid.device)
    wide[:, :valid.shape[1]] = valid
    return wide[:, :valid.shape[1]]


def check_attention(torch, A) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for label, b, t, h, dh, lens, holes in _attention_cases():
        for dtype, tol in ((torch.float32, 5e-5), (torch.bfloat16, 1.6e-2)):
            if dtype == torch.bfloat16 and dh % 8:
                continue
            q, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            valid = torch.arange(t, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
            for row, start, stop in holes:
                valid[row, start:stop] = False
            out = A.fused_attention(q, k, v, _strided(torch, valid))
            ref = A.attention_reference(q, k, v, valid)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            print(f"[kernels] fused_attention {label} B{b} T{t} H{h} dh{dh} {dtype}: "
                  f"max_abs_err {err:.3g} (tol {tol:g})", flush=True)
            check(err <= tol, f"fused_attention {label} {dtype}: {err} > {tol}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    return {"max_abs_err": worst}


TIMES = ("ms", "plain_ms", "library_ms", "bound_ms")


def attention_times(torch, A, b, t, h, dh, lens, dtype, gen) -> tuple:
    """(kernel, plain, SDPA, bound) ms, the bound's kind and the f32 bound at the CUDA
    cores' rate (None for bf16) for one call."""
    from speechflow_torch.tools import attention_times as AT

    r = AT.times(A, *AT.inputs(b, t, h, dh, lens, dtype, gen))
    return (r["ms"], r["plain_ms"], r["library_ms"], *AT.bound_ms(b, t, h, dh, lens, dtype))


def time_attention(torch, A) -> dict:
    from speechflow_torch.tools.attention_times import ROWS, TYPES

    gen = torch.Generator(device="cuda").manual_seed(2)
    for b, t, lens in XTTS_PROMPT_CASES:  # timed beside the paths' shapes, both types
        for name, dtype in TYPES.items():
            ms, plain, lib, bms, kind, _ = attention_times(torch, A, b, t, 4, 256, lens, dtype,
                                                           gen)
            print(f"[kernels] fused_attention xtts-prompt-T{t} B{b} T{t} H4 dh256 {name}: kernel "
                  f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms "
                  f"({kind})", flush=True)
    # per batch (request) of each serving path (the tool's rows)
    by_path, kinds = {}, {}
    for program, label, b, t, h, dh, lens, calls, type_name in ROWS:
        total = by_path.setdefault(program, dict.fromkeys(TIMES, 0.0))
        ms, plain, lib, bms, kind, cores = attention_times(torch, A, b, t, h, dh, lens,
                                                           TYPES[type_name], gen)
        kinds.setdefault(program, {})
        kinds[program][kind] = kinds[program].get(kind, 0.0) + calls * bms
        cores = f", CUDA-core bound {cores:.5f} ms" if cores is not None else ""
        print(f"[kernels] fused_attention {program} {label} B{b} T{t} H{h} dh{dh} {type_name}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bms:.5f} ms ({kind}{cores}), {bms / ms:.3f} of it; {calls} launches per "
              f"batch", flush=True)
        for key, val in zip(TIMES, (ms, plain, lib, bms)):
            total[key] += calls * val
    # the top-level numbers are one flagship batch's, as for the anti-alias entries;
    # bound_by names the bound of most of that time
    res = dict(by_path["flagship"], bound_by=max(kinds["flagship"], key=kinds["flagship"].get))
    for key in TIMES:
        res[f"{key}_by_path"] = {p: t[key] for p, t in by_path.items()}
    return res


def upsample_conv(torch, AA, x, taps: int):
    """Stage 1 as one PyTorch call, the yardstick of ``aa_upsample_fir``: a depthwise
    ``conv1d`` with 2 outputs per channel (even, odd phase) over x (B, T, C)."""
    import torch.nn.functional as F

    c = x.shape[-1]
    filt = AA.kaiser_sinc_filter(taps=taps)
    p = (taps - 1) // 2
    offsets = [(k - p + 1) // 2 for k in range(taps)]  # x offset of each tap in stage 1
    half = max(abs(o) for o in offsets)
    w = torch.zeros(2, 2 * half + 1)
    for k, o in enumerate(offsets):
        w[(k - p) % 2, o + half] += 2.0 * float(filt[k])
    w = w.repeat(c, 1)[:, None].to(x.device, x.dtype)
    return lambda: F.conv1d(x.transpose(1, 2), w, padding=half, groups=c)


def check_anti_alias(torch, AA) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"anti_alias_snake": 0.0, "aa_upsample_fir": 0.0, "aa_snake_downsample": 0.0}
    # the six head stages at B=2 (T as on the path), T not a multiple of the run, odd C;
    # then large snake arguments (x * 30, log alpha up to 1.5) in f32: |out| reaches ~130,
    # where one f32 ulp is 7.6e-6 and the two sides sum in other orders, so that case is
    # held at 1e-5 of the output's scale
    shapes = [(2, t, c, 1.0) for t, c in HEAD_STAGES] + [(3, 1000, 70, 1.0),
                                                        (2, 300, 33, 1.0), (2, 3000, 48, 30.0)]
    for b, t, c, scale in shapes:
        x32 = scale * torch.randn(b, t, c, generator=gen, device="cuda")
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        if scale > 1:
            a = torch.linspace(-0.5, 1.5, c, device="cuda")
        bt = 0.3 * torch.randn(c, generator=gen, device="cuda")
        for taps in (12, 8):
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3.2e-2)):
                if scale > 1 and dtype == torch.bfloat16:
                    continue
                x = x32.to(dtype)
                pairs = {}
                pairs["anti_alias_snake"] = (AA.anti_alias_snake(x, a, bt, taps),
                                             AA.anti_alias_snake_reference(x, a, bt, taps))
                ye, yo = AA.aa_upsample_fir(x, taps)
                pe, po = AA.aa_upsample_fir_reference(x, taps)
                pairs["aa_upsample_fir"] = (torch.cat([ye, yo]), torch.cat([pe, po]))
                pairs["aa_snake_downsample"] = (
                    AA.aa_snake_downsample(pe, po, a, bt, taps),
                    AA.aa_snake_downsample_reference(pe, po, a, bt, taps))
                torch.cuda.synchronize()
                errs = []
                for name, (out, ref) in pairs.items():
                    err = (out.float() - ref.float()).abs().max().item()
                    lim = tol * max(1.0, ref.float().abs().max().item()) if scale > 1 else tol
                    check(err <= lim, f"{name} B{b} T{t} C{c} taps{taps} {dtype}: {err} > {lim}")
                    if dtype == torch.bfloat16:
                        worst[name] = max(worst[name], err)
                    errs.append(f"{name} {err:.3g} (tol {lim:.3g})")
                print(f"[kernels] anti-alias B{b} T{t} C{c} x{scale:g} taps{taps} {dtype}: "
                      f"max_abs_err " + ", ".join(errs), flush=True)
    # the upsample yardstick computes the same function
    x = torch.randn(2, 1000, 70, generator=gen, device="cuda")
    lib = upsample_conv(torch, AA, x, 12)()
    pe, po = AA.aa_upsample_fir_reference(x, 12)
    err = max((lib[:, 0::2] - pe.transpose(1, 2)).abs().max().item(),
              (lib[:, 1::2] - po.transpose(1, 2)).abs().max().item())
    print(f"[kernels] upsample yardstick (depthwise conv1d) vs plain, f32: max_abs_err "
          f"{err:.3g} (tol 1e-5)", flush=True)
    check(err <= 1e-5, f"upsample yardstick disagrees with the plain version: {err}")
    return worst


def time_anti_alias(torch, AA) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    res = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
           for n in ("anti_alias_snake", "aa_upsample_fir", "aa_snake_downsample")}
    taps = 12
    for i, (t, c) in enumerate(HEAD_STAGES):
        x = torch.randn(BATCH, t, c, generator=gen, device="cuda", dtype=torch.bfloat16)
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        bt = 0.3 * torch.randn(c, generator=gen, device="cuda")
        ye, yo = AA.aa_upsample_fir(x, taps)
        n_el = x.numel()
        es = x.element_size()
        calls = {"anti_alias_snake": 6 + (1 if i == len(HEAD_STAGES) - 1 else 0),
                 "aa_upsample_fir": 1, "aa_snake_downsample": 3}
        runs = {
            "anti_alias_snake": (lambda: AA.anti_alias_snake(x, a, bt, taps),
                                 lambda: AA.anti_alias_snake_reference(x, a, bt, taps),
                                 2 * n_el * es, (4 * taps + 10) * n_el),
            "aa_upsample_fir": (lambda: AA.aa_upsample_fir(x, taps),
                                lambda: AA.aa_upsample_fir_reference(x, taps),
                                3 * n_el * es, 2 * taps * n_el),
            "aa_snake_downsample": (lambda: AA.aa_snake_downsample(ye, yo, a, bt, taps),
                                    lambda: AA.aa_snake_downsample_reference(ye, yo, a, bt, taps),
                                    3 * n_el * es, (2 * taps + 10) * n_el),
        }
        for name, (kern, plain, nbytes, ops) in runs.items():
            ms = cuda_ms(kern, 5)
            pms = cuda_ms(plain, 2, warmup=1)
            bms, kind = bound_ms(nbytes, ops, "f32")  # arithmetic is f32 for both dtypes
            res[name]["ms"] += calls[name] * ms
            res[name]["plain_ms"] += calls[name] * pms
            res[name]["bound_ms"] += calls[name] * bms
            res[name]["bound_by"] = kind
            lib = ""
            if name == "aa_upsample_fir":
                lms = cuda_ms(upsample_conv(torch, AA, x, taps), 5)
                res[name]["library_ms"] = (res[name]["library_ms"] or 0.0) + calls[name] * lms
                lib = f"conv1d {lms:.4f} ms, "
            print(f"[kernels] {name} B{BATCH} T{t} C{c} bf16 taps{taps}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, {lib}bound {bms:.4f} ms ({kind}); "
                  f"{calls[name]} launches per batch", flush=True)
        del x, ye, yo
        torch.cuda.empty_cache()
    return res


def phase_kernels(torch) -> dict:
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = {"fused_attention": check_attention(torch, A)}
    records["fused_attention"].update(time_attention(torch, A))
    for name, err in check_anti_alias(torch, AA).items():
        records[name] = {"max_abs_err": err}
    for name, r in time_anti_alias(torch, AA).items():
        records[name].update(r)
    return records


# -- phase 4 ---------------------------------------------------------------------


def _counters():
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A

    return {"fused_attention": A.fused_attention, "anti_alias_snake": AA.anti_alias_snake,
            "aa_upsample_fir": AA.aa_upsample_fir,
            "aa_snake_downsample": AA.aa_snake_downsample}


def _vjp_counters():
    """The VJP functions that count their kernel's launches (also while a planted fault
    or a counting wrapper stands in the module's name)."""
    from speechflow_torch.ops import anti_alias as AA

    return dict(AA._VJP_COUNTERS)


def reset_counts() -> None:
    for fn in (*_counters().values(), *_vjp_counters().values()):
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def read_vjp_counts() -> dict:
    """The anti-alias VJP kernels' launches (kept apart from ``read_counts``: only the
    training paths run them)."""
    return {name: fn.launches for name, fn in _vjp_counters().items()}


@contextlib.contextmanager
def uncounted():
    """Launches inside are left out of the path's counts (a comparison with plain)."""
    saved = {**read_counts(), **read_vjp_counts()}
    try:
        yield
    finally:
        for name, fn in {**_counters(), **_vjp_counters()}.items():
            fn.launches = saved[name]


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions (on the card)."""
    from speechflow_torch.models.vocoder import heads
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.ops import attention as A
    from speechflow_torch.ops import folded

    saved = [(A, "fused_attention", A.fused_attention)]
    A.fused_attention = A.attention_reference
    for mod in (heads, folded):  # the unfolded head and the folded one
        for name in ("anti_alias_snake", "aa_upsample_fir", "aa_snake_downsample"):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(AA, name + "_reference"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_batches(torch, am, vm, label: str, expected: dict, features: bool,
                gpu_line: str) -> dict:
    """N_BATCHES request batches at bench shape through ``serving.synthesize``:
    waveform shape, finiteness, loudness and launch counts per batch checked;
    ms a batch and x realtime over the batches after the first."""
    import numpy as np

    from speechflow_torch import serving

    rng = np.random.default_rng(0)
    n_samples = (T_FRAMES - 1) * HOP
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for i in range(N_BATCHES):
        inputs = serving.bench_inputs(rng, batch=BATCH, features=features)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = read_counts()
        per_batch = {k: after[k] - before[k] for k in after}
        check(tuple(wav.shape) == (BATCH, n_samples),
              f"{label}: waveform shape {tuple(wav.shape)} != {(BATCH, n_samples)}")
        w = wav.float()
        check(bool(torch.isfinite(w).all()), f"{label}: non-finite waveform")
        std = w.std(dim=-1).min().item()
        check(std > 1e-4, f"{label}: silent waveform (min per-utterance std {std:.3g})")
        check(per_batch == expected, f"{label}: launches per batch {per_batch} != {expected}")
        print(f"[{label}] batch {i}: {dt * 1e3:.1f} ms, wave {tuple(wav.shape)}, "
              f"min std {std:.4f}, launches {per_batch}", flush=True)
        if i > 0:  # the first batch also selects cuDNN algorithms and fills caches
            times.append(dt)
    ms = 1e3 * sum(times) / len(times)
    xrt = BATCH * n_samples / SR / (ms / 1e3)
    print(f"[{label}] end to end: {ms:.1f} ms per batch of {BATCH} x {n_samples / SR:.2f} s "
          f"= {xrt:.1f}x realtime (bf16, batches after the first, {gpu_line})", flush=True)
    return {"ms_per_batch": ms, "xrt": xrt}


def rel_limit(ref) -> float:
    """The f32 gate for an output whose plain reference is ``ref``."""
    return TOL_F32_REL * ref.abs().max().item()


def kernels_vs_plain(torch, am, vm, label: str, features: bool):
    """One f32 batch of 2 through the kernels and through the plain versions:
    equal integer durations, then mel (valid frames) and waveform within
    ``rel_limit``. Returns the kernels' mel."""
    import numpy as np

    from speechflow_torch import serving

    inputs = serving.bench_inputs(np.random.default_rng(1), batch=2, features=features)
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn(am.noise_shape(inputs, T_FRAMES), generator=gen,
                        device="cuda") * am.decoder.temperature
    outs = []
    for ctx in (contextlib.nullcontext(), plain_versions()):
        with ctx, torch.inference_mode():
            x = inputs.to("cuda", torch.float32)
            out = am.inference(x, t_out=T_FRAMES, noise=noise)
            mel = out.spectrogram[-1]
            outs.append((out.attention.sum(1), out.spectrogram_lengths, mel,
                         vm.from_features(mel)))
    (d_k, len_k, mel_k, wav_k), (d_p, _, mel_p, wav_p) = outs
    check(torch.equal(d_k, d_p), f"{label}: predicted durations differ (kernels, plain)")
    valid = (torch.arange(T_FRAMES, device="cuda")[None] < len_k[:, None])[..., None]
    mel_err = ((mel_k - mel_p).abs() * valid).max().item()
    mel_lim = rel_limit(mel_p * valid)
    wav_err = (wav_k - wav_p).abs().max().item()
    wav_lim = rel_limit(wav_p)
    print(f"[{label}] f32 B2 kernels vs plain: durations equal ({int(d_k.sum())} frames), "
          f"mel max_abs_err {mel_err:.3g} (tol {mel_lim:.3g}), wave max_abs_err "
          f"{wav_err:.3g} (tol {wav_lim:.3g} = {TOL_F32_REL:g} x max|wave| "
          f"{wav_lim / TOL_F32_REL:.3g})", flush=True)
    check(mel_err <= mel_lim and wav_err <= wav_lim, f"{label} f32: kernels disagree with plain")
    return mel_k


@contextlib.contextmanager
def unfolded_head(vm):
    """The vocoder with its folded head's inner, unfolded head (same weights)."""
    folded_head = vm.head
    vm.head = folded_head.inner
    try:
        yield vm
    finally:
        vm.head = folded_head


def vocoder_ms(torch, vm, mel) -> dict:
    """The vocoder alone on one batch's mel, folded and unfolded, in turns
    (unfolded, folded, folded, unfolded) after a warm-up of each."""
    times = {"folded": [], "unfolded": []}

    def once(kind):
        ctx = unfolded_head(vm) if kind == "unfolded" else contextlib.nullcontext()
        with ctx, torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vm.from_features(mel)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

    once("unfolded")
    once("folded")
    for kind in ("unfolded", "folded", "folded", "unfolded"):
        times[kind].append(once(kind))
    return {k: sum(v) / len(v) for k, v in times.items()}


def planted_fold_faults(torch, vm, mel, wav_u) -> dict:
    """The folded head's waveform error against the unfolded one with one
    fault planted at a time: the first dilated conv of the first MRF branch
    with its folded taps shifted by one, in the first and in the last folded
    stage."""
    geom = [(i, c, f) for i, (_, c, f) in enumerate(vm.head.geom) if f > 1]
    errs = {}
    for k in (0, len(geom) - 1):
        w = vm.head.res_f[k][0].convs[0].w_f
        saved = w.data
        w.data = saved.roll(1, 0)
        with torch.inference_mode():
            wav = vm.from_features(mel)
        w.data = saved
        i, c, f = geom[k]
        errs[f"stage {i + 1} (C{c} F{f}) taps shifted"] = (wav - wav_u).abs().max().item()
    return errs


def phase_slice(torch, gpu_line: str) -> dict:
    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.bfloat16, seed=0)
    check(isinstance(vm.head, FoldedSnakeHead), "the flagship vocoder's head is not folded")
    print(f"[slice] flagship built (bf16, seeded random weights, head folded: per stage "
          f"(rate, C, F) {vm.head.geom}) in {time.perf_counter() - t0:.1f} s", flush=True)

    reset_counts()
    res = run_batches(torch, am, vm, "slice", EXPECTED_LAUNCHES, True, gpu_line)
    res["launches"] = read_counts()
    mel = torch.randn(BATCH, T_FRAMES, 100, generator=torch.Generator(device="cuda")
                      .manual_seed(3), device="cuda", dtype=torch.bfloat16) - 4.0
    voc = vocoder_ms(torch, vm, mel)
    res["vocoder_ms"] = voc
    print(f"[slice] vocoder alone, bf16 B{BATCH} T{T_FRAMES}: folded head {voc['folded']:.1f} ms, "
          f"unfolded head {voc['unfolded']:.1f} ms per batch (two calls each, in turns; "
          f"{gpu_line})", flush=True)
    del am, vm, mel
    torch.cuda.empty_cache()

    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.float32, seed=0)
    mel = kernels_vs_plain(torch, am, vm, "slice", True)
    with torch.inference_mode():
        wav_f = vm.from_features(mel)
        with unfolded_head(vm):
            wav_u = vm.from_features(mel)
    err, lim = (wav_f - wav_u).abs().max().item(), rel_limit(wav_u)
    print(f"[slice] f32 B2 folded vs unfolded head: wave max_abs_err {err:.3g} "
          f"(tol {lim:.3g})", flush=True)
    check(err <= lim, "f32: the folded head disagrees with the unfolded one")
    for stage, fault_err in planted_fold_faults(torch, vm, mel, wav_u).items():
        print(f"[slice] f32 B2 planted fault, {stage}: wave max_abs_err {fault_err:.3g} "
              f"(the gate {lim:.3g} must reject it)", flush=True)
        check(fault_err > lim, f"the folded-head gate passes a planted fault ({stage})")
    del am, vm
    torch.cuda.empty_cache()
    return res


def phase_toy(torch, gpu_line: str) -> dict:
    from speechflow_torch import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    am, vm = serving.build_toy(device="cuda", dtype=torch.bfloat16, seed=0)
    print(f"[toy] toy program built (bf16, seeded random weights) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reset_counts()
    res = run_batches(torch, am, vm, "toy", TOY_LAUNCHES, False, gpu_line)
    res["launches"] = read_counts()
    del am, vm
    torch.cuda.empty_cache()
    am, vm = serving.build_toy(device="cuda", dtype=torch.float32, seed=0)
    kernels_vs_plain(torch, am, vm, "toy", False)
    del am, vm
    torch.cuda.empty_cache()
    return res


def phase_interface(torch, gpu_line: str) -> dict:
    """The vocoder eval interface over the flagship BigVGAN vocoder, f32."""
    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.vocoder import VocosParams
    from speechflow_torch.models.vocoder.folded_head import FoldedSnakeHead

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = VocosParams.create(serving.VOCODER_BIGVGAN_PRESETS["default"])
    vm = seeded_vocoder(torch, params)
    vi = VocoderEvaluationInterface(vm.to("cuda"))
    check(isinstance(vi.model.head, FoldedSnakeHead), "the interface's head is not folded")
    rng = np.random.default_rng(5)
    mel = (rng.normal(size=(T_FRAMES, params.n_mels)) - 4.0).astype(np.float32)
    # 1022 hops = 10.90 s: a whole number of hops, so the resynthesis is as long
    n = (T_FRAMES - 2) * HOP
    tt = np.arange(n) / SR
    wav = (0.3 * np.sin(2 * np.pi * 220.0 * tt * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * tt)))
           + 0.05 * rng.normal(size=n)).astype(np.float32)

    reset_counts()
    t0 = time.perf_counter()
    syn = vi.synthesize(mel)
    t1 = time.perf_counter()
    out = vi.resynthesize(AudioChunk(data=wav, sr=SR))
    t2 = time.perf_counter()
    launches = read_counts()
    expected = {"fused_attention": 0, **{k: 2 * v for k, v in HEAD_LAUNCHES.items()}}
    check(launches == expected, f"interface: launches {launches} != {expected}")
    for what, chunk, length in (("synthesize", syn, (T_FRAMES - 1) * HOP),
                                ("resynthesize", out, n)):
        check(chunk.data.shape == (length,), f"{what}: {chunk.data.shape} != ({length},)")
        check(bool(np.isfinite(chunk.data).all()), f"{what}: non-finite waveform")
        check(float(chunk.data.std()) > 1e-4, f"{what}: silent waveform")
    print(f"[interface] f32, folded head: synthesize (1024, 100) mel -> {syn.data.shape[0]} "
          f"samples in {1e3 * (t1 - t0):.1f} ms; resynthesize {n / SR:.2f} s "
          f"(mel on the card) -> {len(out)} samples in {1e3 * (t2 - t1):.1f} ms "
          f"(first calls, {gpu_line}); launches {launches}", flush=True)
    with plain_versions():
        ref = vi.resynthesize(AudioChunk(data=wav, sr=SR))
    err = float(np.abs(out.data - ref.data).max())
    lim = TOL_F32_REL * float(np.abs(ref.data).max())
    print(f"[interface] f32 resynthesis kernels vs plain: max_abs_err {err:.3g} "
          f"(tol {lim:.3g})", flush=True)
    check(err <= lim, "interface: the kernels disagree with the plain versions")
    del vi, vm
    torch.cuda.empty_cache()
    return {"launches": launches}


# the text request of the tts_interface phase: one paragraph of 32 English sentences
# (punctuation, numbers, years, ordinals, a price, times of day, several lengths); the
# interface splits it at . ! ? ; followed by a space, so no sentence holds one inside
REQUEST_SENTENCES = (
    "The quick brown fox jumps over the lazy dog.",
    "On June 3rd, 1998, the bridge finally opened to traffic.",
    "Please call me back before 5:30 tomorrow.",
    "It rained.",
    "We sold 2,500 tickets in the first week alone!",
    "Is this the 21st time you have asked me that question?",
    "The museum was founded in 1874 by a group of local merchants.",
    "Yes.",
    "The doctor will see you now, so please take a seat.",
    "A ticket costs $12.50, but children travel for free.",
    "The results, however, were far better than anyone expected.",
    "She finished in 2nd place, just behind her older brother.",
    "Turn left at the next corner, then walk 200 meters.",
    "Why would anyone leave the door open in the middle of winter?",
    "Our train leaves at 7:45 sharp.",
    "Around 45% of the voters stayed at home.",
    "He read the letter twice, folded it, and put it in his pocket.",
    "Good morning, everyone!",
    "The company was founded in 2005 and now employs 340 people.",
    "Keep calm and carry on.",
    "The 19th century saw rapid growth in the city's population.",
    "I can't believe it's already October.",
    "Mix 3 cups of flour with 2 eggs and a pinch of salt.",
    "Where did you put the keys?",
    "The meeting has been moved to Thursday, the 14th of March.",
    "Thank you for waiting.",
    "In 1969, two astronauts walked on the Moon for the first time.",
    "The river is about 1,200 kilometers long.",
    "My brother and his wife live on the same quiet street.",
    "Stop!",
    "After a long pause, the old man smiled and nodded slowly.",
    "That will be all for today, see you next week.",
)
SSML_REQUEST = ('Please speak <prosody rate="x-slow">these few words very slowly</prosody> '
                'and then go on as usual.')
TTS_REQUESTS = 1  # timed requests after the first


def _valid_mel(out):
    """The export chain's vocoder input: the sentences' valid postnet frames, in order."""
    import torch

    mels, lens = out.after_postnet_spectrogram, out.spectrogram_lengths.tolist()
    return torch.cat([mels[j, :n] for j, n in enumerate(lens)]), lens


def tts_request(torch, ti, vi, sentences, ctx, opts, gen=None, noise=None) -> dict:
    """One request as the export chain serves it: the sentences' batch (host
    frontend), the acoustic model, the valid frames concatenated, one vocoder call;
    the host clock around each part, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inputs = ti.prepare_batch(sentences, ctx, opts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = ti.evaluate(inputs, opts, noise=noise, generator=gen)
    mel, lens = _valid_mel(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    audio = vi.synthesize(mel)
    t3 = time.perf_counter()
    return {"inputs": inputs, "out": out, "mel": mel, "lens": lens, "wave": audio.data,
            "ms": {"frontend": 1e3 * (t1 - t0), "acoustic": 1e3 * (t2 - t1),
                   "vocoder": 1e3 * (t3 - t2), "total": 1e3 * (t3 - t0)}}


def phase_tts_interface(torch, gpu_line: str) -> dict:
    """Text -> speech through the eval interfaces at flagship width: the payload
    a trainer of the flagship stores (``serving.flagship_payload``: the text pipe of
    ``configs/tts_data_24khz.yml``, an alphabet of the char fallback's symbols of the
    request, 8 speakers, EN/RU), ``TTSEvaluationInterface`` over the seeded acoustic
    model and ``VocoderEvaluationInterface`` over the BigVGAN vocoder. The models are
    built once, in f32 for the gates, then cast to bf16 for the timed requests (the
    weights ``build_flagship`` gives in bf16: both round the same f32 draw)."""
    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.data.processors.ssml import parse_ssml
    from speechflow_torch.data.processors.text import TextParserHook
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    text = " ".join(REQUEST_SENTENCES)
    plain_ssml = parse_ssml(SSML_REQUEST)[0]
    payload = serving.flagship_payload(TextParserHook()(text + " " + plain_ssml))
    opts = TTSOptions(t_out=T_FRAMES)

    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.float32, seed=0)
    ti, vi = TTSEvaluationInterface(am, payload), VocoderEvaluationInterface(vm)
    speaker = ti.get_speakers()[0]  # the export chain's default speaker
    ctx = ti.prepare_embeddings(ti.create_context("EN", speaker))
    sentences = ti.split_sentences(text)
    check(len(sentences) == len(REQUEST_SENTENCES),
          f"tts_interface: {len(sentences)} sentences, not {len(REQUEST_SENTENCES)}")
    print(f"[tts_interface] built (f32, seeded weights; alphabet of {len(ti.alphabet)} "
          f"symbols, char fallback; pipe {ti.pipeline.handler_names}; speaker {speaker}) in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # f32: a request of 2 sentences through the kernels and the plain versions, and the
    # interface's acoustic output against serving.synthesize's on the same inputs
    gen = torch.Generator(device="cuda").manual_seed(0)
    two = [REQUEST_SENTENCES[1], REQUEST_SENTENCES[3]]
    inputs = ti.prepare_batch(two, ctx, opts)
    noise = torch.randn(am.noise_shape(inputs, T_FRAMES), generator=gen,
                        device="cuda") * am.decoder.temperature
    res = []
    for mode in (contextlib.nullcontext(), plain_versions()):
        with mode:
            res.append(tts_request(torch, ti, vi, two, ctx, opts, noise=noise))
    (d_k, mel_k, wav_k), (d_p, mel_p, wav_p) = (
        (r["out"].attention.sum(1), r["mel"], r["wave"]) for r in res)
    check(torch.equal(d_k, d_p), "tts_interface f32: durations differ (kernels, plain)")
    mel_err, mel_lim = (mel_k - mel_p).abs().max().item(), rel_limit(mel_p)
    wav_err = float(np.abs(wav_k - wav_p).max())
    wav_lim = TOL_F32_REL * float(np.abs(wav_p).max())
    print(f"[tts_interface] f32 2 sentences kernels vs plain: durations equal "
          f"({int(d_k.sum())} frames), mel max_abs_err {mel_err:.3g} (tol {mel_lim:.3g}), "
          f"wave max_abs_err {wav_err:.3g} (tol {wav_lim:.3g})", flush=True)
    check(mel_err <= mel_lim and wav_err <= wav_lim,
          "tts_interface f32: kernels disagree with plain")
    out = res[0]["out"]  # interface.evaluate on these inputs and this noise
    with torch.inference_mode():
        ref = am.inference(inputs.to("cuda", torch.float32), t_out=T_FRAMES, noise=noise)
        wav_s = serving.synthesize(am, vm, inputs, t_out=T_FRAMES, noise=noise)
        err = (out.spectrogram - ref.spectrogram).abs().max().item()
        err_w = (vm.from_features(out.spectrogram[-1]) - wav_s).abs().max().item()
    print(f"[tts_interface] f32 interface.evaluate vs the serving program's acoustic model: "
          f"mel max_abs_err {err:.3g}, wave {err_w:.3g} (tol 1e-6)", flush=True)
    check(err <= 1e-6 and err_w <= 1e-6, "tts_interface: evaluate differs from serving")
    del res, out, ref, wav_s

    # bf16: the timed requests of 32 sentences
    ti = TTSEvaluationInterface(am.to(torch.bfloat16), payload)
    vm.to(torch.bfloat16)
    reset_counts()
    runs = []
    for i in range(1 + TTS_REQUESTS):
        before = read_counts()
        r = tts_request(torch, ti, vi, sentences, ctx, opts, gen=gen)
        after = read_counts()
        per_request = {k: after[k] - before[k] for k in after}
        check(per_request == EXPECTED_LAUNCHES,
              f"tts_interface: launches per request {per_request} != {EXPECTED_LAUNCHES}")
        wave, lens = r["wave"], r["lens"]
        check(wave.shape == ((sum(lens) - 1) * HOP,) and bool(np.isfinite(wave).all()),
              f"tts_interface: waveform {wave.shape}, finite {np.isfinite(wave).all()}")
        bounds = np.cumsum([0] + lens) * HOP
        std = min(float(wave[a:b].std()) for a, b in zip(bounds[:-1], bounds[1:]))
        check(std > 1e-4, f"tts_interface: silent utterance (min std {std:.3g})")
        r["audio_s"] = len(wave) / SR
        ms = r["ms"]
        print(f"[tts_interface] request {i}: {len(sentences)} sentences, tokens "
              f"{tuple(r['inputs'].transcription.shape)}, frames {min(lens)}..{max(lens)} "
              f"(sum {sum(lens)}, {sum(n == T_FRAMES for n in lens)} at t_out) -> "
              f"{r['audio_s']:.2f} s audio, min std {std:.4f}; frontend {ms['frontend']:.1f} "
              f"ms, acoustic {ms['acoustic']:.1f} ms, vocoder {ms['vocoder']:.1f} ms, total "
              f"{ms['total']:.1f} ms; launches {per_request}", flush=True)
        runs.append(r)
    launches = read_counts()
    steady = runs[1:]
    med = {k: float(np.median([r["ms"][k] for r in steady])) for k in steady[0]["ms"]}
    audio_s = float(np.median([r["audio_s"] for r in steady]))
    first = runs[0]["ms"]
    print(f"[tts_interface] per request (bf16, {gpu_line}): first call frontend "
          f"{first['frontend']:.1f} / acoustic {first['acoustic']:.1f} / vocoder "
          f"{first['vocoder']:.1f} / total {first['total']:.1f} ms; median of the next "
          f"{TTS_REQUESTS}: frontend {med['frontend']:.1f} / acoustic {med['acoustic']:.1f} / "
          f"vocoder {med['vocoder']:.1f} / total {med['total']:.1f} ms, host frontend share "
          f"{med['frontend'] / med['total']:.3f}, {audio_s:.2f} s of audio = "
          f"{audio_s / (med['total'] / 1e3):.1f}x realtime", flush=True)

    # SSML: in one batch, the x-slow span must lengthen its utterance against the same
    # words plain (the plain row's modifiers are 1.0); neither may be cut at t_out
    both = ti.prepare_batch([SSML_REQUEST, plain_ssml], ctx, opts)
    check(both.rate_modifier is not None and bool((both.rate_modifier[1] == 1).all()),
          "tts_interface: the SSML batch lost its modifiers")
    frames = ti.evaluate(both, opts, generator=gen).spectrogram_lengths.tolist()
    print(f"[tts_interface] SSML rate=x-slow: {frames[0]} frames, the same words plain "
          f"{frames[1]} frames (one batch)", flush=True)
    check(frames[0] > frames[1] and max(frames) < T_FRAMES,
          f"tts_interface: x-slow did not slow: {frames}")
    del am, vm, ti, vi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[tts_interface] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": launches, "ms": med, "first_ms": first, "audio_s": audio_s,
            "phase_s": phase_s}


# -- phases 8 and 9: XTTS serving, the bundle and the demo server ---------------------

_WORK: tp.Dict[str, tp.Any] = {}


def seeded_vocoder(torch, params):
    """``Vocos(params)`` with ``serving.init_random_``'s seed-0 weights, built on the card
    (its constructor's initialisers, which those overwrite, take seconds on a CPU)."""
    from speechflow_torch import serving
    from speechflow_torch.models.vocoder import Vocos

    with torch.device("cuda"):
        return serving.init_random_(Vocos(params), torch.Generator().manual_seed(0))


def workdir() -> Path:
    """A temporary directory for the run's checkpoints and bundle, removed at exit."""
    if "dir" not in _WORK:
        import tempfile

        _WORK["dir"] = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    return _WORK["dir"]


def request_symbols() -> list:
    """The char fallback's symbols of the request sentences: the alphabet of the
    payloads of the XTTS and bundle phases."""
    from speechflow_torch.data.processors.ssml import parse_ssml
    from speechflow_torch.data.processors.text import TextParserHook

    return TextParserHook()(" ".join(REQUEST_SENTENCES) + " " + parse_ssml(SSML_REQUEST)[0])


def xtts_checkpoint(torch) -> Path:
    """A port checkpoint of the XTTS recipe at full width (``configs/xtts_model.yml``
    default: 1024 x 12 x 8 GPT, 4 prompt blocks of 4 heads, the codec 32 channels at
    strides 4·8·8, 4 quantizers of 1024) with weights from flax's initialisers under
    ``torch.manual_seed(0)``, written by the port's saver with the payload a trainer
    stores (the text pipe of ``configs/tts_data_24khz.yml``, the request's char
    alphabet, 8 speakers). Built once a run."""
    if "xtts" in _WORK:
        return _WORK["xtts"]
    import dataclasses

    from speechflow_torch import serving
    from speechflow_torch.convert import nnx_from_module
    from speechflow_torch.models.tts import XTTSModel, XTTSParams
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.training.saver import ExperimentSaver

    payload = serving.flagship_payload(request_symbols())
    info = payload["pipeline_info"]
    params = XTTSParams.create(dict(
        TT.configs("default", "configs/xtts_model.yml")[0]["model"],
        n_symbols=len(info["alphabet"]["symbols"]),
        n_speakers=len(info["singletons"]["SpeakerIDSetter"]["speaker2id"]),
        prompt_dim=serving.TTS_DATA_CONFIG["preproc"]["pipe_cfg"]["linear_to_mel"]["n_mels"]))
    torch.manual_seed(0)
    with torch.device("cuda"):  # the initialisers run on the card
        model = XTTSModel(params)
    saver = ExperimentSaver(workdir(), expr_suffix="xtts")
    saver.to_save.update({"model_params": dataclasses.asdict(params), "pipeline_info": info})
    _WORK["xtts"] = saver.save(0, nnx_from_module(model))
    return _WORK["xtts"]


def prompt_wave():
    """A synthetic reference utterance of XTTS_PROMPT_FRAMES mel frames at 24 kHz: a
    vibrato tone with a formant-like second partial and noise, from a seed."""
    import numpy as np

    n = (XTTS_PROMPT_FRAMES - 1) * HOP
    tt = np.arange(n) / SR
    f0 = 140.0 * (1 + 0.05 * np.sin(2 * np.pi * 5.0 * tt))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wav = 0.3 * np.sin(phase) + 0.1 * np.sin(3 * phase)
    return (wav + 0.01 * np.random.default_rng(6).normal(size=n)).astype(np.float32)


def xtts_request_inputs(torch, xi, sentences, wave):
    """Text ids padded to the interface's multiple (id 0), prompt mels and speakers
    of a batch, on the card, as ``XTTSEvaluationInterface.synthesize`` builds one row."""
    import numpy as np

    from speechflow_torch.interface.xtts_interface import TOKEN_MULTIPLE
    from speechflow_torch.io.audio import AudioChunk

    ids = [xi.prepare_text(s) for s in sentences]
    width = max(len(i) for i in ids)
    width += (-width) % TOKEN_MULTIPLE
    ids = np.stack([np.pad(i, (0, width - len(i))) for i in ids])
    mel = xi.prompt_mel_from_audio(AudioChunk(data=wave, sr=SR))
    b = len(sentences)
    return (torch.from_numpy(ids).to("cuda"),
            torch.from_numpy(np.repeat(mel[None], b, 0)).to("cuda"),
            torch.full((b,), mel.shape[0], dtype=torch.int32, device="cuda"),
            torch.arange(b, device="cuda") % len(xi.speaker2id))


def xtts_kernels_vs_plain(torch, xi, wave) -> None:
    """One greedy request through the kernels and through the plain versions (f32):
    the prompt embeddings and the prefill logits within ``rel_limit``; then the
    first decoded step where the tokens differ, if one does, with the kernels'
    top-2 logit margin there."""
    model, gpt = xi.model, xi.model.gpt
    ids, mel, lens, sid = xtts_request_inputs(torch, xi, REQUEST_SENTENCES[:1], wave)
    runs = []
    for mode in (contextlib.nullcontext(), plain_versions()):
        with mode, torch.inference_mode():
            emb, elen = model._encode_prompt(mel, lens)
            cond = model._cond(sid)
            bos = torch.full((1, 1), gpt.bos, dtype=torch.long, device="cuda")
            prefill = gpt._trunk(ids, bos, cond, emb, elen)[:, -1]
            toks = gpt.generate(ids, max_tokens=XTTS_GREEDY_TOKENS, temperature=0.0,
                                cond=cond, prompt_emb=emb, prompt_lengths=elen)
        runs.append((emb, prefill, toks))
    (emb_k, pre_k, tok_k), (emb_p, pre_p, tok_p) = runs
    emb_err, emb_lim = (emb_k - emb_p).abs().max().item(), rel_limit(emb_p)
    pre_err, pre_lim = (pre_k - pre_p).abs().max().item(), rel_limit(pre_p)
    differ = (tok_k != tok_p)[0].nonzero()
    where = f"none of the {XTTS_GREEDY_TOKENS} tokens differ"
    if len(differ):
        i = int(differ[0])
        with torch.inference_mode():
            logits = gpt(ids, tok_k, cond, prompt_emb=emb_k, prompt_lengths=elen)[0, i]
        top = logits.topk(2).values
        where = (f"first differing token at step {i} (kernels' top-2 logit margin there "
                 f"{(top[0] - top[1]).item():.3g})")
    print(f"[xtts] f32 greedy request kernels vs plain: prompt embeddings max_abs_err "
          f"{emb_err:.3g} (tol {emb_lim:.3g}), prefill logits max_abs_err {pre_err:.3g} "
          f"(tol {pre_lim:.3g}); {where}", flush=True)
    check(emb_err <= emb_lim and pre_err <= pre_lim, "xtts f32: kernels disagree with plain")


def xtts_breakdown(torch, xi, wave, request_ms: float, gpu_line: str) -> dict:
    """The ms a decoded token: a ``XTTS_MAX_TOKENS``-token and a 1-token generate on
    the same ids, prompt and seed (``XTTS_DECODE_RUNS`` of each, alternating; the
    medians' difference over the 511 steps between them). Then one request's stages
    (host clock, synchronised): the host frontend (text ids, prompt mel), the
    prompt encoder, the prefill (the 1-token generate), the decode and the codec's
    decode, against ``request_ms`` (a whole request). Then a 17-token and a 1-token
    request under ``torch.profiler``: the device's busy share over the first, and
    the kernels a decode step launches from their difference (the profiler's
    post-processing takes seconds a thousand kernels, so the window is short)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, gpt = xi.model, xi.model.gpt
    gen = torch.Generator(device="cuda").manual_seed(0)

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    with torch.inference_mode():
        (ids, mel, lens, sid), host = clock(
            lambda: xtts_request_inputs(torch, xi, REQUEST_SENTENCES[:1], wave))
        (emb, elen), enc = clock(lambda: model._encode_prompt(mel, lens))
        cond = model._cond(sid)
        run = functools.partial(gpt.generate, ids, temperature=0.8, generator=gen, cond=cond,
                                prompt_emb=emb, prompt_lengths=elen)
        walls = {1: [], XTTS_MAX_TOKENS: []}
        for _ in range(XTTS_DECODE_RUNS):
            for n in walls:
                gen.manual_seed(0)
                walls[n].append(clock(lambda: run(max_tokens=n))[1])
        prefill, full = (float(np.median(walls[n])) for n in (1, XTTS_MAX_TOKENS))
        per_token = (full - prefill) / (XTTS_MAX_TOKENS - 1)
        decode = per_token * (XTTS_MAX_TOKENS - 1)
        codes = torch.randint(0, model.n_codes, (1, XTTS_MAX_TOKENS), generator=gen,
                              device="cuda")
        _, codec = clock(lambda: model.codec.decode(codes[..., None]))
        rest = request_ms - host - enc - prefill - decode - codec
        # the weights every decode step reads, and the KV cache at the mean position
        t_prefix = ids.shape[1] + 1 + emb.shape[1] + 1
        trunk = sum(p.numel() * p.element_size() for m in (gpt.blocks, gpt.norm, gpt.head)
                    for p in m.parameters())
        kv = (2 * len(gpt.blocks) * (t_prefix + XTTS_MAX_TOKENS / 2) * gpt.head.in_features
              * emb.element_size())
        token_bound = (trunk + kv) / HBM_BYTES_PER_S * 1e3
        n_prof = 16  # decode steps after the prefill's token
        profiled = {}
        for n in (1, 1 + n_prof):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = clock(lambda: run(max_tokens=n))
            busy, kernels = 0.0, 0
            for e in prof.key_averages():
                if (e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
                        and not e.key.startswith(HOST_ROWS)):
                    busy += _self_device_us(e)
                    kernels += e.count
            profiled[n] = (busy, kernels, wall)
    busy, kernels, wall = profiled[1 + n_prof]
    check(busy > 0, "xtts: the profiler recorded no device time")
    share = busy / 1e3 / wall
    per_step = (kernels - profiled[1][1]) / n_prof
    runs = {n: ", ".join(f"{w:.2f}" for w in ws) for n, ws in walls.items()}
    print(f"[xtts] decode (f32, B1, {gpu_line}): {per_token:.3f} ms per token = generate of "
          f"{XTTS_MAX_TOKENS} tokens {full:.1f} ms (runs {runs[XTTS_MAX_TOKENS]}) minus of 1 "
          f"token {prefill:.2f} ms (runs {runs[1]}), over {XTTS_MAX_TOKENS - 1}; per-token "
          f"bound {token_bound:.4f} ms (GPT trunk {trunk / 1e6:.1f} MB + KV cache "
          f"{kv / 1e6:.1f} MB at the mean position, over HBM)",
          flush=True)
    print(f"[xtts] one request's stages (f32, B1): host frontend {host:.1f} ms, prompt "
          f"encoder {enc:.2f} ms, prefill {prefill:.2f} ms (prefix of {t_prefix} positions), "
          f"decode {decode:.1f} ms, codec decode {codec:.2f} ms; the median request "
          f"{request_ms:.1f} ms leaves {rest:.1f} ms", flush=True)
    print(f"[xtts] a {1 + n_prof}-token request under torch.profiler: device busy "
          f"{busy / 1e3:.1f} ms of {wall:.1f} ms wall ({share:.3f} busy share), {kernels} "
          f"kernels, {per_step:.0f} a decode step", flush=True)
    return {"host_ms": host, "prompt_encoder_ms": enc, "prefill_ms": prefill,
            "ms_per_token": per_token, "codec_ms": codec, "rest_ms": rest,
            "token_bound_ms": token_bound, "busy_share": share, "kernels_per_token": per_step}


def phase_xtts(torch, gpu_line: str) -> dict:
    """XTTS text requests through ``XTTSEvaluationInterface`` at the recipe's full
    width, f32 (as the JAX interface serves it), from a port checkpoint."""
    import numpy as np

    from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = xtts_checkpoint(torch)
    t_built = time.perf_counter()
    xi = XTTSEvaluationInterface(ckpt, device="cuda")
    n_params = sum(p.numel() for p in xi.model.parameters())
    wave = prompt_wave()
    mel = xi.prompt_mel_from_audio(AudioChunk(data=wave, sr=SR))
    check(mel.shape == (XTTS_PROMPT_FRAMES, xi.params.prompt_dim),
          f"xtts: prompt mel {mel.shape}")
    print(f"[xtts] checkpoint written in {t_built - t_phase:.1f} s, loaded in "
          f"{time.perf_counter() - t_built:.1f} s ({n_params / 1e6:.1f} M parameters, f32; "
          f"prompt {mel.shape[0]} frames)", flush=True)
    xtts_kernels_vs_plain(torch, xi, wave)

    audio_s = XTTS_MAX_TOKENS * HOP / SR
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    speaker = xi.get_speakers()[0]
    for i in range(XTTS_REQUESTS):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = xi.synthesize(REQUEST_SENTENCES[i], speaker=speaker, max_tokens=XTTS_MAX_TOKENS,
                            temperature=0.8, seed=i, ref_audio=AudioChunk(data=wave, sr=SR))
        times.append(1e3 * (time.perf_counter() - t0))
        after = read_counts()
        per_request = {k: after[k] - before[k] for k in after}
        check(per_request == XTTS_LAUNCHES,
              f"xtts: launches per request {per_request} != {XTTS_LAUNCHES}")
        check(out.data.shape == (XTTS_MAX_TOKENS * HOP,) and out.sr == SR
              and bool(np.isfinite(out.data).all()),
              f"xtts: waveform {out.data.shape} at {out.sr} Hz, finite "
              f"{np.isfinite(out.data).all()}")
        print(f"[xtts] request {i}: {times[-1]:.1f} ms, {audio_s:.2f} s of audio, std "
              f"{out.data.std():.4f}; launches {per_request}", flush=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    print(f"[xtts] per request (f32, {XTTS_MAX_TOKENS} tokens, {gpu_line}): first "
          f"{times[0]:.1f} ms, median of the next {XTTS_REQUESTS - 1} {med:.1f} ms = "
          f"{audio_s / (med / 1e3):.2f}x realtime; peak device memory {peak:.2f} GiB",
          flush=True)
    res = {"launches": launches, "first_ms": times[0], "ms": med, "xrt": audio_s / (med / 1e3),
           "peak_gib": peak}
    res.update(xtts_breakdown(torch, xi, wave, med, gpu_line))

    ids, mels, lens, sid = xtts_request_inputs(torch, xi, REQUEST_SENTENCES[:XTTS_BATCH], wave)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = xi.model.synthesize(ids, sid, max_tokens=XTTS_MAX_TOKENS, temperature=0.8,
                              generator=gen, prompt_mel=mels, prompt_mel_lengths=lens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(tuple(wav.shape) == (XTTS_BATCH, XTTS_MAX_TOKENS * HOP)
          and bool(torch.isfinite(wav).all()), f"xtts batch: waveform {tuple(wav.shape)}")
    res["batch_tokens_per_s"] = XTTS_BATCH * XTTS_MAX_TOKENS / dt
    print(f"[xtts] batch of {XTTS_BATCH} through XTTSModel.synthesize: {1e3 * dt:.1f} ms, "
          f"{res['batch_tokens_per_s']:.1f} tokens/s ({XTTS_BATCH * audio_s / dt:.2f}x "
          f"realtime)", flush=True)
    del xi, wav
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[xtts] phase wall time {res['phase_s']:.1f} s", flush=True)
    return res


def bundle_checkpoints(torch) -> dict:
    """Port checkpoints of the flagship acoustic model and BigVGAN vocoder (seeded
    weights, as ``serving.build_flagship`` draws them; the vocoder unfolded, as a
    trainer saves it), the XTTS one and a prosody model (``prosody_checkpoint``):
    {kind: step directory}."""
    import dataclasses
    import math

    from speechflow_torch import serving
    from speechflow_torch.convert import nnx_from_module
    from speechflow_torch.models.tts import ParallelTTSModel
    from speechflow_torch.models.vocoder import Vocos
    from speechflow_torch.training.saver import ExperimentSaver

    tts_p, voc_p = serving.flagship_params()
    gen = torch.Generator().manual_seed(0)
    with torch.device("cuda"):  # built on the card: the initialisers are overwritten
        am = serving.init_random_(ParallelTTSModel(tts_p), gen)
        vm = serving.init_random_(Vocos(voc_p), gen)
    with torch.no_grad():
        am.variance_adaptor.predictors["durations"].out.bias.fill_(
            math.log1p(serving.FRAMES_PER_TOKEN))
    out = {"xtts": xtts_checkpoint(torch), "prosody": prosody_checkpoint(torch)}
    for kind, model, payload in (
            ("tts", am, serving.flagship_payload(request_symbols())),
            ("vocoder", vm, {"model_params": dataclasses.asdict(voc_p)})):
        saver = ExperimentSaver(workdir(), expr_suffix=kind)
        saver.to_save.update(payload)
        out[kind] = saver.save(0, nnx_from_module(model))
    return out


def http_get(url: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


DEMO_REQUESTS = (" ".join(REQUEST_SENTENCES[:2]), REQUEST_SENTENCES[20])
BUNDLE_SENTENCE = REQUEST_SENTENCES[4]


def bundle_vs_plain(torch, bundle, tts, voc) -> None:
    """The bundle's serving paths at the shapes they give the kernels (f32), through
    the kernels and through the plain versions from one seed: ``bundle.synthesize``
    of ``BUNDLE_SENTENCE`` (``t_out`` 1024, one vocoder call over its frames) and the
    demo server's chain on its first request (``t_out`` ``T_OUT``, a vocoder call a
    sentence). Equal lengths, then each mel (valid frames) and waveform within
    ``rel_limit``."""
    import numpy as np

    from speechflow_torch.app.demo_server import T_OUT
    from speechflow_torch.interface.tts_interface import TTSOptions

    runs = []
    for mode in (contextlib.nullcontext(), plain_versions()):
        with mode:
            torch.manual_seed(3)  # the acoustic model's noise: torch's generator
            chain = bundle.synthesize(BUNDLE_SENTENCE).data
            torch.manual_seed(4)
            out = tts.synthesize(DEMO_REQUESTS[0], speaker=tts.get_speakers()[0],
                                 opts=TTSOptions(t_out=T_OUT))
            lens = out.spectrogram_lengths.tolist()
            mels = [out.after_postnet_spectrogram[j, :n] for j, n in enumerate(lens)]
            runs.append((chain, lens, [m.float().cpu().numpy() for m in mels],
                         [voc.synthesize(m).data for m in mels]))
    (chain_k, lens_k, mels_k, waves_k), (chain_p, lens_p, mels_p, waves_p) = runs
    check(chain_k.shape == chain_p.shape and lens_k == lens_p,
          f"bundle f32: lengths differ (kernels, plain): {chain_k.shape} {chain_p.shape}, "
          f"{lens_k} {lens_p}")
    pairs = [("bundle.synthesize wave", chain_k, chain_p)]
    for j in range(len(lens_k)):
        pairs += [(f"demo sentence {j} mel", mels_k[j], mels_p[j]),
                  (f"demo sentence {j} wave", waves_k[j], waves_p[j])]
    worst = []
    for what, got, ref in pairs:
        err = float(np.abs(got - ref).max())
        lim = TOL_F32_REL * float(np.abs(ref).max())
        worst.append(f"{what} {err:.3g} (tol {lim:.3g})")
        check(err <= lim, f"bundle f32: {what} kernels disagree with plain: {err} > {lim}")
    print(f"[bundle] f32 kernels vs plain at the bundle's and the demo's shapes "
          f"({len(chain_k)} samples; demo frames {lens_k}): max_abs_err "
          + ", ".join(worst), flush=True)


def phase_bundle(torch, gpu_line: str) -> dict:
    """The serving entry points: ``pack`` the three checkpoints,
    ``InferenceBundle.load`` the archive on the card (f32), serve
    ``bundle.synthesize`` and ``bundle.xtts.synthesize``, then the demo server
    on a free port in a thread answers /, /info, two /synthesize and a 404."""
    import io
    import threading
    import wave as wavefile

    import numpy as np

    from speechflow_torch.app.demo_server import T_OUT, make_server
    from speechflow_torch.interface.tts_interface import TTSOptions
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.scripts.export import InferenceBundle, pack

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpts = bundle_checkpoints(torch)
    t0 = time.perf_counter()
    archive = pack(workdir() / "bundle.sftpu.tar.gz", **ckpts)
    t1 = time.perf_counter()
    bundle = InferenceBundle.load(archive, device="cuda")
    t2 = time.perf_counter()
    tts, voc, xi = bundle.tts, bundle.vocoder, bundle.xtts
    t3 = time.perf_counter()
    check(tts.prosody_interface is not None
          and next(tts.prosody_interface.model.parameters()).is_cuda,
          "bundle: the TTS interface has no prosody model on the card")
    print(f"[bundle] checkpoints written in {t0 - t_phase:.1f} s; packed "
          f"{archive.stat().st_size / 2**30:.2f} GiB in {t1 - t0:.1f} s, extracted in "
          f"{t2 - t1:.1f} s, interfaces built on the card in {t3 - t2:.1f} s", flush=True)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = bundle.synthesize(BUNDLE_SENTENCE)
    t1 = time.perf_counter()
    check(audio.sr == SR and len(audio.data) > 0 and len(audio.data) % HOP == 0
          and bool(np.isfinite(audio.data).all()) and float(audio.data.std()) > 1e-4,
          f"bundle.synthesize: {audio.data.shape} at {audio.sr} Hz")
    xa = xi.synthesize(REQUEST_SENTENCES[5], speaker=xi.get_speakers()[1],
                       max_tokens=BUNDLE_XTTS_TOKENS, ref_audio=AudioChunk(data=prompt_wave(),
                                                                           sr=SR))
    t2 = time.perf_counter()
    check(xa.data.shape == (BUNDLE_XTTS_TOKENS * HOP,) and bool(np.isfinite(xa.data).all()),
          f"bundle.xtts.synthesize: {xa.data.shape}")
    print(f"[bundle] bundle.synthesize (one sentence, t_out 1024, f32): {len(audio.data)} "
          f"samples in {1e3 * (t1 - t0):.1f} ms; bundle.xtts.synthesize ({BUNDLE_XTTS_TOKENS} "
          f"tokens, a prompt): {1e3 * (t2 - t1):.1f} ms", flush=True)

    srv = make_server(tts, voc, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, ctype, body = http_get(base + "/")
        check(code == 200 and ctype == "text/html" and b"<form" in body, f"GET /: {code}")
        code, ctype, body = http_get(base + "/info")
        info = json.loads(body) if code == 200 else {}
        check(info.get("speakers") == tts.get_speakers()
              and info.get("languages") == tts.get_languages(), f"GET /info: {code} {info}")
        wavs = []
        for text in DEMO_REQUESTS:
            query = "/synthesize?" + urllib.parse.urlencode({"text": text, "lang": "EN"})
            t0 = time.perf_counter()
            code, ctype, body = http_get(base + query)
            ms = 1e3 * (time.perf_counter() - t0)
            check(code == 200 and ctype == "audio/wav" and body[:4] == b"RIFF"
                  and body[8:12] == b"WAVE", f"GET /synthesize: {code} {ctype} {body[:12]}")
            with wavefile.open(io.BytesIO(body)) as w:
                fmt = (w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes())
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            wavs.append((text, fmt, ms, pcm))
        check(http_get(base + "/nothing")[0] == 404, "GET /nothing: not 404")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    launches = read_counts()
    # again, warm (the first call above also paid one-time costs: library loads, plans)
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        bundle.synthesize(BUNDLE_SENTENCE)  # returns the waveform on the host: synchronised
        warm.append(1e3 * (time.perf_counter() - t0))
    print(f"[bundle] bundle.synthesize warm: median {sorted(warm)[1]:.1f} ms (runs "
          f"{', '.join(f'{x:.1f}' for x in warm)})", flush=True)
    bundle_vs_plain(torch, bundle, tts, voc)
    for text, (sr, ch, width, frames), ms, pcm in wavs:
        # the expected length: each sentence's frames (the durations do not depend on
        # the noise) through the vocoder, (frames - 1) hops each
        out = tts.synthesize(text, lang="EN", speaker=tts.get_speakers()[0],
                             opts=TTSOptions(t_out=T_OUT))
        want = sum(n - 1 for n in out.spectrogram_lengths.tolist()) * HOP
        print(f"[bundle] GET /synthesize ({len(tts.split_sentences(text))} sentences): "
              f"{ms:.1f} ms, WAV {sr} Hz x {ch} ch x {8 * width} bit, {frames} frames "
              f"(expected {want}), pcm std {pcm.std():.1f}", flush=True)
        check((sr, ch, width) == (SR, 1, 2) and frames == want and pcm.std() > 0,
              "GET /synthesize: WAV header or length")
    print(f"[bundle] demo server answered GET /, /info, 2 x /synthesize, 404; launches "
          f"{launches}", flush=True)
    del bundle, tts, voc, xi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[bundle] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": launches, "phase_s": phase_s}


# -- phase 10: training ---------------------------------------------------------------


def _aa_grads(torch, fn, inputs, cotangents):
    """``fn(*inputs)``'s outputs and the gradients of every input under ``cotangents``."""
    xs = [x.detach().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, xs, cotangents)


def check_vjps(torch, AA) -> dict:
    """Each entry's autograd Function against PyTorch autograd of its plain version,
    at the head's training stage shapes (B=2), f32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {}
    for t, c in TRAIN_STAGES + [(1000, 33)]:
        x32 = torch.randn(2, t, c, generator=gen, device="cuda")
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        b = 0.3 * torch.randn(c, generator=gen, device="cuda")
        g32 = torch.randn(2, t, c, generator=gen, device="cuda")
        g2 = torch.randn(2, t, c, generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, TOL_F32_REL), (torch.bfloat16, TOL_BF16_GRAD)):
            x, g, h = x32.to(dtype), g32.to(dtype), g2.to(dtype)
            ye, yo = AA.aa_upsample_fir_reference(x, 12)
            cases = {
                "anti_alias_snake": ((AA.anti_alias_snake, AA.anti_alias_snake_reference),
                                     (x, a, b), (g,)),
                "aa_upsample_fir": ((AA.aa_upsample_fir, AA.aa_upsample_fir_reference),
                                    (x,), (g, h)),
                "aa_snake_downsample": ((AA.aa_snake_downsample,
                                         AA.aa_snake_downsample_reference),
                                        (ye, yo, a, b), (g,)),
            }
            errs = []
            for name, ((kern, plain), inputs, cots) in cases.items():
                got = _aa_grads(torch, kern, inputs, cots)
                ref = _aa_grads(torch, plain, inputs, cots)
                torch.cuda.synchronize()
                for i, (u, v) in enumerate(zip(got, ref)):
                    err = (u.float() - v.float()).abs().max().item()
                    lim = tol * v.float().abs().max().item()
                    check(u.dtype == v.dtype and err <= lim,
                          f"{name} VJP input {i} T{t} C{c} {dtype}: {err} > {lim}")
                    worst[name] = max(worst.get(name, 0.0), err / max(lim, 1e-30) * tol)
                    errs.append(f"{name}[{i}] {err:.3g}/{lim:.3g}")
            print(f"[train] VJP vs plain autograd B2 T{t} C{c} {dtype}: " + ", ".join(errs),
                  flush=True)
    return worst


def time_vjps(torch, AA) -> dict:
    """Forward kernel, VJP kernel and plain VJP (``*_vjp_reference``) times of each entry
    at B=32, bf16, summed over one training micro-batch's calls (per stage: 6 fused, +1
    post at the last; 1 stage-1; 3 snake + stage 2); and each VJP kernel's outputs against
    the plain VJP's on the same inputs, at the run lengths training gives them, within
    ``TOL_BF16_GRAD`` of the plain output's largest magnitude (``vjp_err``: the worst
    error as a share of that magnitude)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    res = {n: {"train_fwd_ms": 0.0, "vjp_ms": 0.0, "vjp_plain_ms": 0.0, "vjp_err": 0.0}
           for n in ("anti_alias_snake", "aa_upsample_fir", "aa_snake_downsample")}
    for i, (t, c) in enumerate(TRAIN_STAGES):
        x = torch.randn(BATCH, t, c, generator=gen, device="cuda", dtype=torch.bfloat16)
        g = torch.randn_like(x)
        a = 0.3 * torch.randn(c, generator=gen, device="cuda")
        b = 0.3 * torch.randn(c, generator=gen, device="cuda")
        with torch.no_grad():
            ye, yo = AA.aa_upsample_fir(x)
        calls = {"anti_alias_snake": 6 + (i == len(TRAIN_STAGES) - 1), "aa_upsample_fir": 1,
                 "aa_snake_downsample": 3}
        runs = {
            "anti_alias_snake": (lambda: AA.anti_alias_snake(x, a, b),
                                 lambda: AA.anti_alias_snake_vjp(x, a, b, g),
                                 lambda: AA.anti_alias_snake_vjp_reference(x, a, b, g)),
            "aa_upsample_fir": (lambda: AA.aa_upsample_fir(x),
                                lambda: AA.aa_upsample_fir_vjp(g, g),
                                lambda: AA.aa_upsample_fir_vjp_reference(g, g).to(x.dtype)),
            "aa_snake_downsample": (lambda: AA.aa_snake_downsample(ye, yo, a, b),
                                    lambda: AA.aa_snake_downsample_vjp(ye, yo, a, b, g),
                                    lambda: AA.aa_snake_downsample_vjp_reference(
                                        ye, yo, a, b, g)),
        }
        for name, (fwd, vjp, plain) in runs.items():
            with torch.no_grad():
                f_ms, v_ms = cuda_ms(fwd, 5), cuda_ms(vjp, 5)
                p_ms = cuda_ms(plain, 3, warmup=1)
                got, ref = vjp(), plain()
            got, ref = (v if isinstance(v, tuple) else (v,) for v in (got, ref))
            errs = []
            for j, (u, v) in enumerate(zip(got, ref)):
                scale = v.float().abs().max().item()
                err = (u.float() - v.float()).abs().max().item() / max(scale, 1e-30)
                check(u.dtype == v.dtype and err <= TOL_BF16_GRAD,
                      f"{name} VJP kernel output {j} B{BATCH} T{t} C{c} bf16: {err} of the "
                      f"plain VJP's scale > {TOL_BF16_GRAD}")
                res[name]["vjp_err"] = max(res[name]["vjp_err"], err)
                errs.append(f"{err:.3g}")
            del got, ref
            res[name]["train_fwd_ms"] += calls[name] * f_ms
            res[name]["vjp_ms"] += calls[name] * v_ms
            res[name]["vjp_plain_ms"] += calls[name] * p_ms
            print(f"[train] {name} B{BATCH} T{t} C{c} bf16: forward kernel {f_ms:.4f} ms, "
                  f"VJP kernel {v_ms:.4f} ms, plain VJP {p_ms:.4f} ms; {calls[name]} calls "
                  f"per micro-batch; VJP kernel against plain, of scale: {', '.join(errs)}",
                  flush=True)
        del x, g, ye, yo
        torch.cuda.empty_cache()
    return res


def _seg_waves(n: int, length: int, offset: int = 24000):
    """``n`` SEGS utterances at 24 kHz, ``length`` samples each from ``offset``."""
    import numpy as np

    from speechflow_torch.io.audio import AudioChunk

    files = sorted((REPO / "tests" / "data" / "SEGS").rglob("*.wav"))[:n]
    return np.stack([AudioChunk(file_path=f).load(sr=SR).waveform[offset:offset + length]
                     for f in files]).astype(np.float32)


def gan_grads(torch, gen, disc, gen_crit, disc_crit, wav) -> tuple:
    """One f32 GAN micro-batch without the optimizers: the generator's losses and
    gradients (discriminator frozen), then the discriminator's on the detached
    output. Returns ({loss: value}, {parameter: gradient})."""
    from speechflow_torch.training.gan_trainer import frozen

    for p in (*gen.parameters(), *disc.parameters()):
        p.grad = None
    inputs = {"waveform": wav}
    with frozen(disc):
        out = gen(inputs)
        g_losses = gen_crit(out, disc, inputs, inputs, 0)
        sum(g_losses.values()).backward()
    d_losses = disc_crit(out.detach(), disc, inputs, inputs, 0)
    sum(d_losses.values()).backward()
    losses = {**{f"gen/{k}": v.item() for k, v in g_losses.items()},
              **{f"disc/{k}": v.item() for k, v in d_losses.items()}}
    grads = {f"{tag}.{n}": p.grad.detach().clone()
             for tag, m in (("gen", gen), ("disc", disc)) for n, p in m.named_parameters()}
    return losses, grads


def worst_relative(ref: dict, got: dict) -> tuple:
    """(largest max|got - ref| / max|ref| over the tensors, its name)."""
    return max(((got[n] - v).abs().max().item() / max(v.abs().max().item(), 1e-30), n)
               for n, v in ref.items())


def gan_disagreement(ref: tuple, got: tuple, grad_tol: float) -> tp.List[str]:
    """Losses outside ``TOL_F32_REL`` and gradients outside ``grad_tol`` of the
    reference's magnitude."""
    bad = [f"{k}: {got[0][k]} vs {v}" for k, v in ref[0].items()
           if abs(got[0][k] - v) > TOL_F32_REL * abs(v)]
    for name, v in ref[1].items():
        err = (got[1][name] - v).abs().max().item()
        if err > grad_tol * v.abs().max().item():
            bad.append(f"{name}: max_abs_err {err:.3g} (max |grad| {v.abs().max().item():.3g})")
    return bad


def gen_vjp(torch, gen, wav, cot) -> dict:
    """The generator's parameter gradients under the cotangent ``cot`` of its output."""
    for p in gen.parameters():
        p.grad = None
    gen({"waveform": wav}).backward(cot)
    return {f"gen.{n}": p.grad.detach().clone() for n, p in gen.named_parameters()}


@contextlib.contextmanager
def planted_dbeta_fault(beta, negate: str = "d_beta"):
    """The fused entry's VJP with ``negate`` (``d_beta``, or ``dx``) negated for the snake
    whose β is ``beta`` (every snake when None)."""
    from speechflow_torch.ops import anti_alias as AA

    real = AA.anti_alias_snake_vjp
    before = real.launches

    def faulty(x, alpha, b, g, taps=12):
        grads = dict(zip(("dx", "d_alpha", "d_beta"), real(x, alpha, b, g, taps)))
        if beta is None or b.data_ptr() == beta.data_ptr():
            grads[negate] = -grads[negate]
        return grads["dx"], grads["d_alpha"], grads["d_beta"]

    AA.anti_alias_snake_vjp = faulty
    try:
        yield
    finally:
        AA.anti_alias_snake_vjp = real
    check(real.launches > before, "planted fault: the fused VJP kernel never ran under it")


@contextlib.contextmanager
def pinned_kinks(torch, pins: dict):
    """The discriminators' leaky ReLUs and the hinge losses with each element's side of
    0 replayed from ``pins["masks"]`` (recorded in call order when it is None), as
    ``pinned_relus`` pins the acoustic model's ReLUs: the kernels' ~1e-6 forward
    difference can carry an element across 0, where the slope jumps (0.1 to 1, 0 to
    1); pinned, the two runs differ only where the losses are smooth.
    ``pins["flips"]`` counts the elements that took the other side here."""
    from speechflow_torch.models.vocoder import criterion
    from speechflow_torch.models.vocoder import discriminators as D

    record = pins.get("masks") is None
    if record:
        pins["masks"] = []
    pins["flips"], calls = 0, iter(range(len(pins["masks"])))

    def side(on):
        if record:
            pins["masks"].append(on)
            return on
        mask = pins["masks"][next(calls)]
        pins["flips"] += int((mask != on).sum())
        return mask

    def leaky_relu(x, negative_slope=0.1):
        return torch.where(side(x >= 0), x, x * negative_slope)

    def hinge(x):
        return x * side(x > 0)

    real = D.leaky_relu, criterion._relu
    D.leaky_relu, criterion._relu = leaky_relu, hinge
    try:
        yield
    finally:
        D.leaky_relu, criterion._relu = real


def gan_gate(torch) -> None:
    """The full-width f32 gate, cuDNN deterministic, kernels against the plain versions:

    A. the generator's backward from one cotangent (the plain run's gradient of its
       losses with respect to its output): every parameter's gradient within
       ``TOL_F32_REL`` of the plain one's largest magnitude;
    B. one whole GAN micro-batch: losses within ``TOL_F32_REL``, every gradient of
       both models within ``TOL_GAN_GRAD``: the losses' kinks (hinge, leaky ReLU, the
       log-mel's clip, log|X|) turn the two implementations' ~1e-6 forward difference
       into larger gradient differences, which the plain path run twice shows as 0.
       The discriminators' leaky ReLUs and the hinges are pinned to the plain run's
       sides (``pinned_kinks``; the elements that crossed are counted): with flax's
       initialisers a handful of crossings moved a discriminator bias's gradient by
       1.5e-2 of its scale;
    and a planted fault (dβ negated in one snake's VJP) that both must reject."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.training.gan_trainer import frozen

    model_cfg, _ = TV.configs(TRAIN_PRESET)
    params = VocosParams.create(model_cfg["model"])
    torch.manual_seed(0)
    gen = Vocos(params).to("cuda")
    disc = VocoderDiscriminator(**model_cfg["discriminator"]).to("cuda")
    gen_crit = vocoder_gen_criterion(sample_rate=params.sample_rate, n_mels=params.n_mels,
                                     **model_cfg["loss"])
    disc_crit = vocoder_disc_criterion()
    wav = torch.from_numpy(_seg_waves(2, 8192)).to("cuda")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    pins: dict = {}
    try:
        with plain_versions():
            with pinned_kinks(torch, pins):
                ref = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
            with pinned_kinks(torch, pins):
                again = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
            with frozen(disc):
                out = gen({"waveform": wav})
                total = sum(gen_crit(out, disc, {"waveform": wav}, {"waveform": wav},
                                     0).values())
                cot = torch.autograd.grad(total, out)[0].detach()
            ref_vjp = gen_vjp(torch, gen, wav, cot)
        got_vjp = gen_vjp(torch, gen, wav, cot)
        with pinned_kinks(torch, pins):
            got = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
        flips = pins["flips"]
        with planted_dbeta_fault(gen.head.post_act.beta):
            bad_vjp = gen_vjp(torch, gen, wav, cot)
            with pinned_kinks(torch, pins):
                bad = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    wa, wb, w0 = worst_relative(ref_vjp, got_vjp), worst_relative(ref[1], got[1]), \
        worst_relative(ref[1], again[1])
    print(f"[train] f32 GAN micro-batch B2 x 8192, cuDNN deterministic; losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f". A (generator backward, one cotangent): {len(ref_vjp)} gradients, worst "
          f"relative {wa[0]:.3g} ({wa[1]}; tol {TOL_F32_REL:g}). B (the micro-batch): "
          f"{len(ref[1])} gradients, worst relative {wb[0]:.3g} ({wb[1]}; tol "
          f"{TOL_GAN_GRAD:g}; {flips} of {sum(m.numel() for m in pins['masks'])} pinned "
          f"kink elements crossed 0), plain run twice {w0[0]:.3g}", flush=True)
    check(wa[0] <= TOL_F32_REL, f"train f32 A: generator gradients disagree: {wa}")
    fails = gan_disagreement(ref, got, TOL_GAN_GRAD)
    check(not fails, "train f32 B: kernels disagree with plain: " + "; ".join(fails[:5]))
    fa, fb = worst_relative(ref_vjp, bad_vjp), gan_disagreement(ref, bad, TOL_GAN_GRAD)
    print(f"[train] planted fault (dβ negated in the post snake's VJP): A worst relative "
          f"{fa[0]:.3g} ({fa[1]}), B rejects with {len(fb)} disagreement(s): {fb[:2]}",
          flush=True)
    check(fa[0] > TOL_F32_REL and bool(fb), "the training gate passes a planted dβ fault")
    del gen, disc, got, ref, again, bad
    torch.cuda.empty_cache()


def phase_train(torch, gpu_line: str) -> dict:
    """GAN training of the flagship vocoder through the port's entry point."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.ops import anti_alias as AA
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training import gan_trainer as GT
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"vjp": check_vjps(torch, AA), "times": time_vjps(torch, AA)}
    gan_gate(torch)

    model_cfg, data_cfg = TV.configs(TRAIN_PRESET)
    data_cfg["dirs"]["data_root"] = str(REPO / "tests" / "data" / "SEGS")
    model_cfg["trainer"]["max_steps"] = TRAIN_MICRO_BATCHES
    k = model_cfg["optimizer"]["grad_accum"]
    st = {"gen_ref": None, "sizes": [], "times": [], "launches": [], "trainer": None,
          "losses": []}
    real_gen_step = GT.GANTrainer._generator_step

    def gen_step(self, inputs, targets, step):
        """The trainer's generator step, checked: the discriminator's weights and
        gradients are as they were."""
        if st["gen_ref"] is None:
            st["gen_ref"] = [p.detach().clone() for p in self.generator.parameters()]
        d_ref = [p.detach().clone() for p in self.discriminator.parameters()]
        out = real_gen_step(self, inputs, targets, step)
        same = all(torch.equal(p, q) and p.grad is None
                   for p, q in zip(self.discriminator.parameters(), d_ref))
        check(same, f"train: the generator step at micro-batch {step + 1} touched the "
                    "discriminator")
        st["sizes"].append(tuple(inputs["waveform"].shape))
        return out

    def callback(trainer, last):
        torch.cuda.synchronize()
        st["times"].append(time.perf_counter())
        st["trainer"] = trainer
        counts, vjp_counts = read_counts(), read_vjp_counts()
        st["launches"].append(counts)
        reset_counts()
        i = trainer.global_step
        vals = {key: float(v) for key, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()), f"train: non-finite loss {vals}")
        check(counts == TRAIN_LAUNCHES,
              f"train: launches at micro-batch {i}: {counts} != {TRAIN_LAUNCHES}")
        check(vjp_counts == TRAIN_VJP_LAUNCHES,
              f"train: VJP launches at micro-batch {i}: {vjp_counts} != {TRAIN_VJP_LAUNCHES}")
        changed = any(not torch.equal(p, r) for p, r in
                      zip(trainer.generator.parameters(), st["gen_ref"]))
        opt = trainer.gen_opt
        check(opt.count == i // k and opt.mini_step == i % k,
              f"train: optimizer count {opt.count}, mini-step {opt.mini_step} after {i}")
        check(changed == (i >= 2 * k),
              f"train: generator {'changed' if changed else 'unchanged'} after micro-batch {i}")
        if i == k:  # the first optimizer step: lr 0 at count 0, moments taken
            moments = [s["exp_avg"] for s in opt.base.state.values()]
            check(len(moments) == len(opt.params) and any(bool(m.abs().max() > 0)
                                                          for m in moments),
                  "train: the first optimizer step left no Adam moments")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        GT.GANTrainer._generator_step = gen_step
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            expr = TV.train(model_cfg, data_cfg, saver, device="cuda",
                            callbacks=[callback])
            t_fit = time.perf_counter() - t0
        finally:
            GT.GANTrainer._generator_step = real_gen_step
        peak = torch.cuda.max_memory_allocated()
        launches = {key: sum(c[key] for c in st["launches"]) for key in TRAIN_LAUNCHES}
        ends = [t0] + st["times"]
        step_ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
        audio_s = [b * n / SR for b, n in st["sizes"]]
        ms = statistics.median(step_ms[1:])
        by_size = {b: statistics.median(t for t, (bb, _) in zip(step_ms[1:], st["sizes"][1:])
                                        if bb == b)
                   for b in sorted({b for b, _ in st["sizes"][1:]})}
        opt_ms = sum(step_ms[k:2 * k])
        rate = sum(audio_s[1:]) / (sum(step_ms[1:]) / 1e3)
        for i, (dt, size, vals) in enumerate(zip(step_ms, st["sizes"], st["losses"])):
            print(f"[train] micro-batch {i + 1}: {dt:.1f} ms, wave {size}, gen/total "
                  f"{vals['gen/total']:.4f}, disc/total {vals.get('disc/total', 0.0):.4f}",
                  flush=True)
        vjp = sum(r["vjp_ms"] for r in res["times"].values())
        plain_vjp = sum(r["vjp_plain_ms"] for r in res["times"].values())
        fwd = sum(r["train_fwd_ms"] for r in res["times"].values())
        print(f"[train] {TRAIN_MICRO_BATCHES} micro-batches ({TRAIN_MICRO_BATCHES // k} "
              f"optimizer steps) in {t_fit:.1f} s with set-up; per micro-batch {ms:.1f} ms "
              f"(median of 2..{TRAIN_MICRO_BATCHES}; by batch size "
              + ", ".join(f"B{b} {t:.1f} ms" for b, t in by_size.items())
              + f"), second optimizer step "
              f"{opt_ms:.1f} ms, {rate:.2f} s of audio trained per s, peak device memory "
              f"{peak / 2**30:.2f} GiB; anti-alias at B{BATCH}: VJP kernels "
              f"{vjp:.1f} ms (plain VJPs {plain_vjp:.1f} ms) against "
              f"the forward kernels' {fwd:.1f} ms per micro-batch ({vjp / ms:.3f} of a "
              f"micro-batch; {gpu_line})", flush=True)

        # the checkpoint the run wrote, through the vocoder interface
        ckpt = ExperimentSaver.get_last_checkpoint(expr)
        check(ckpt is not None and ckpt.name == f"step_{TRAIN_MICRO_BATCHES:09d}",
              f"train: last checkpoint {ckpt}")
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")
        wav = _seg_waves(1, 64 * HOP * 4, offset=0)[0]
        out = vi.resynthesize(AudioChunk(data=wav, sr=SR)).data
        gen = st["trainer"].generator.eval()
        with torch.no_grad():
            ref = gen({"waveform": torch.from_numpy(wav)[None].to("cuda")})[0]
        ref = np.clip(ref.float().cpu().numpy(), -1.0, 1.0)
        err = float(np.abs(out - ref).max())
        lim = TOL_F32_REL * float(np.abs(ref).max())
        print(f"[train] {ckpt.name} -> load_checkpoint -> VocoderEvaluationInterface "
              f"(folded) -> resynthesize {len(wav) / SR:.2f} s: {out.shape[0]} samples, "
              f"max_abs_err {err:.3g} against the trained generator's f32 output "
              f"(tol {lim:.3g})", flush=True)
        check(out.shape == wav.shape and bool(np.isfinite(out).all()) and err <= lim,
              "train: the reloaded checkpoint does not resynthesize as trained")
        del vi, tree, gen, st["trainer"]
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[train] phase wall time {phase_s:.1f} s", flush=True)
    res.update(launches=launches, ms=ms, ms_by_batch=by_size, opt_ms=opt_ms,
               audio_rate=rate, peak=peak, phase_s=phase_s)
    return res


# -- phase 11: acoustic-model training -----------------------------------------------

TTS_TRAIN_PRESET = "default"
TTS_TRAIN_STEPS = 3  # the cut: step 1 at lr 0, then 2 that move the weights
TTS_G2P_STEPS = 100  # the cut of train_tts's G2P (1200 a member; aux_models gates one of 1200)
# card against CPU, one f32 step (TF32 off): each gradient within this share of its
# tensor's largest magnitude, or of 1e-3 of the model's largest gradient where that is
# more (the attention key biases' true gradient is 0, softmax being shift-invariant, so
# both sides hold only rounding there); each loss within TOL_F32_REL. Both sides take
# the same side of every ReLU kink (``pinned_relus``): a pre-activation within f32
# rounding of 0 that fell the other way on the card moved the next conv's gradient by
# 3.5e-3 of its scale at full width, a kink and not a fault
TOL_TTS_GRAD = 1e-3
ZERO_GRAD_OK = ".attn.key.bias"  # the only parameters whose true gradient is 0
TTS_TRAIN_REQUEST = REQUEST_SENTENCES[:4]  # the reloaded checkpoint's text request


def no_dropout(model) -> None:
    """Every dropout rate of the port's acoustic model to 0."""
    for m in model.modules():
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0


def _on(obj, device):
    """A dataclass of tensors (``TTSForwardInput``, ``TTSTarget``) on ``device``."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@contextlib.contextmanager
def pinned_relus(model, pins: dict):
    """Every ``ConvBlock`` of ``model`` (the training path's only ReLUs) with its ReLU
    as ``pre * mask``: the same values and gradient as ``F.relu`` where ``mask`` is
    ``pre > 0``. With ``pins["masks"]`` None, the masks are recorded in call order;
    else they are replayed, and ``pins["flips"]`` counts the pre-activations that took
    the other side of 0 here."""
    from speechflow_torch.models.tts.common import ConvBlock, dropout

    record = pins.get("masks") is None
    if record:
        pins["masks"] = []
    pins["flips"], calls = 0, iter(range(len(pins["masks"])))

    def forward(block, x, deterministic=True):
        pre = block.norm(block.conv(x))
        if record:
            mask = pre > 0
            pins["masks"].append(mask.cpu())
        else:
            mask = pins["masks"][next(calls)].to(pre.device)
            pins["flips"] += int((mask != (pre > 0)).sum())
        return dropout(pre * mask, block.dropout, deterministic)

    blocks = [m for m in model.modules() if isinstance(m, ConvBlock)]
    for b in blocks:
        b.forward = functools.partial(forward, b)
    try:
        yield
    finally:
        for b in blocks:
            del b.forward


def tts_step_grads(torch, model, crit, inputs, targets, draws) -> tuple:
    """One teacher-forced step without the optimizer: ({loss: value}, {parameter:
    gradient on the CPU})."""
    for p in model.parameters():
        p.grad = None
    losses = crit(model(inputs, training=True, cfm_draws=draws), targets, 0)
    sum(losses.values()).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()})


def worst_rel(got: dict, ref: dict) -> float:
    """The largest error of ``got``'s tensors against ``ref``'s, each relative to the
    reference tensor's largest magnitude."""
    return max((got[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
               for k, v in ref.items())


def tts_disagreement(ref: tuple, got: tuple) -> tuple:
    """(worst loss error relative to the loss, worst gradient error relative to
    ``TOL_TTS_GRAD``'s scale, the parameter it is in)."""
    loss = max(abs(got[0][k] - v) / max(abs(v), 1e-30) for k, v in ref[0].items())
    model_scale = max(v.abs().max().item() for v in ref[1].values())
    grad = max(((got[1][n] - v).abs().max().item()
                / max(v.abs().max().item(), 1e-3 * model_scale), n)
               for n, v in ref[1].items())
    return loss, grad[0], grad[1]


@contextlib.contextmanager
def planted_mu_fault(decoder):
    """``CFMDecoder.forward_train`` with the prior ``mu`` not detached where it enters
    the estimator: the same value, with its graph kept, so the flow-matching loss also
    trains the prior and everything upstream of it."""
    seen = {}
    prior, dphi = decoder.prior.forward, decoder._dphi

    def keep(x):
        seen["content"] = x
        return prior(x)

    def attached(x_t, mu, *args, **kwargs):
        return dphi(x_t, prior(seen["content"]).to(mu.dtype), *args, **kwargs)

    decoder.prior.forward, decoder._dphi = keep, attached
    try:
        yield
    finally:
        del decoder.prior.forward, decoder._dphi


def tts_gate(torch, model_cfg: dict, data_cfg: dict) -> dict:
    """One f32 training step at full width on the card and on the CPU: the same
    seeded random weights (``serving.init_random_``: the DiT modulations, zero at
    initialisation, would leave the DiT trunk's gradients 0), every dropout rate 0,
    the first two train utterances, the same injected u, z and CFG masks (one row's
    content and the other's condition replaced by the learned fake ones), the CPU's
    ReLU masks (``pinned_relus``); TF32 off. No reference gradient is all zero apart
    from ``ZERO_GRAD_OK``'s; losses within ``TOL_F32_REL``, every gradient within
    ``TOL_TTS_GRAD``; the same gate must reject a planted fault (``mu`` not
    detached)."""
    import copy

    from speechflow_torch import serving
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.models.tts.decoders import CFMDraws
    from speechflow_torch.scripts.common import model_config_from_info
    from speechflow_torch.utils.init import filter_kwargs

    t0 = time.perf_counter()
    pipeline = DataPipeline.from_config(data_cfg)
    params = ParallelTTSParams.create(model_config_from_info(model_cfg, pipeline))
    cpu = serving.init_random_(ParallelTTSModel(params), torch.Generator().manual_seed(0))
    no_dropout(cpu)
    card = copy.deepcopy(cpu).to("cuda")
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    inputs, targets = TTSBatchProcessor()(batch)
    draws = cpu.decoder.draw(2, inputs.mel.shape, torch.device("cpu"),
                             torch.Generator().manual_seed(0))._replace(
        drop_content=torch.tensor([True, False]).view(2, 1, 1),
        drop_condition=torch.tensor([False, True]).view(2, 1))
    crit = TTSCriterion(**filter_kwargs(TTSCriterion.__init__, dict(model_cfg["loss"])))
    pins = {}
    with pinned_relus(cpu, pins):
        ref = tts_step_grads(torch, cpu, crit, inputs, targets, draws)
    zero = [k for k, v in ref[1].items() if not v.any() and not k.endswith(ZERO_GRAD_OK)]
    check(not zero, f"tts_train: reference gradients all zero: {zero}")
    args = (crit, _on(inputs, "cuda"), _on(targets, "cuda"),
            CFMDraws(*(a.to("cuda") for a in draws)))
    with pinned_relus(card, pins):
        got = tts_step_grads(torch, card, *args)
    flips = pins["flips"]
    with pinned_relus(card, pins), planted_mu_fault(card.decoder):
        bad = tts_step_grads(torch, card, *args)
    loss_err, grad_err, where = tts_disagreement(ref, got)
    f_loss, f_grad, f_where = tts_disagreement(ref, bad)
    print(f"[tts_train] f32 step at full width, card vs CPU (random weights, B2, mel {tuple(inputs.mel.shape)}, "
          f"tokens {tuple(inputs.transcription.shape)}, TF32 off, dropout 0, injected u, z "
          f"and CFG masks; {time.perf_counter() - t0:.1f} s): losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f"; worst loss error {loss_err:.3g} of the loss (tol {TOL_F32_REL:g}); "
          f"{len(ref[1])} gradients, worst {grad_err:.3g} of scale ({where}; tol "
          f"{TOL_TTS_GRAD:g}); ReLU pre-activations on the other side of 0 on the card, "
          f"pinned to the CPU's: {flips} of {sum(m.numel() for m in pins['masks'])}",
          flush=True)
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"tts_train f32: the card disagrees with the CPU: loss {loss_err}, {where} {grad_err}")
    print(f"[tts_train] planted fault (mu not detached into the CFM estimator): worst loss "
          f"error {f_loss:.3g}, worst gradient {f_grad:.3g} of scale ({f_where})", flush=True)
    check(f_grad > TOL_TTS_GRAD, "the tts_train gate passes a planted fault (mu not detached)")
    del cpu, card, got, ref, bad
    torch.cuda.empty_cache()
    return {"grad_err": grad_err, "loss_err": loss_err, "fault_grad_err": f_grad,
            "relu_flips": flips}


def train_step_flops(torch, trainer, batch) -> float:
    """FLOPs of one training call's forward and backward on ``batch`` (the padded
    shapes the program computes; matmuls, attention's products and convolutions),
    counted by ``torch.utils.flop_counter``. The weights are left as they are."""
    from torch.utils.flop_counter import FlopCounterMode

    from speechflow_torch.training.trainer import _place

    inputs, targets = _place(trainer.batch_processor(batch), trainer.device)
    counter = FlopCounterMode(display=False)
    with counter:
        losses = trainer.criterion(trainer.model(inputs), targets, trainer.global_step)
        sum(losses.values()).backward()
    trainer.model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def phase_tts_train(torch, gpu_line: str) -> dict:
    """Acoustic-model training through the port's entry point, then the checkpoint
    served through the eval interfaces."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.data.processors.text import G2PParserHook
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.ops import attention as A
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg, data_cfg = TT.configs(TTS_TRAIN_PRESET)
    data_cfg["dirs"]["data_root"] = str(REPO / "tests" / "data" / "SEGS")
    model_cfg["trainer"]["max_steps"] = TTS_TRAIN_STEPS
    model_cfg["experiment"]["g2p_steps"] = TTS_G2P_STEPS
    res = {"gate": tts_gate(torch, model_cfg, data_cfg)}

    st = {"ref": None, "steps": [], "ends": [], "losses": [], "trainer": None, "batch": None}
    real_step = Trainer.training_step

    def step(self, batch):
        """The trainer's step, timed (synchronised) with its batch's shape."""
        if st["ref"] is None:
            st["ref"] = [p.detach().clone() for p in self.model.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        st["steps"].append((1e3 * (time.perf_counter() - t0), int(batch.mel_lengths.sum()),
                            tuple(batch.mel.shape), tuple(batch.transcription.shape)))
        st["batch"] = batch
        return out

    def callback(trainer, last):
        torch.cuda.synchronize()
        st["ends"].append(time.perf_counter())
        st["trainer"] = trainer
        i = trainer.global_step
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()), f"tts_train: non-finite loss {vals}")
        check(A.fused_attention.launches == 0,
              f"tts_train: {A.fused_attention.launches} fused attention launches in training")
        changed = any(not torch.equal(p, r)
                      for p, r in zip(trainer.model.parameters(), st["ref"]))
        check(changed == (i >= 2), f"tts_train: weights {'changed' if changed else 'unchanged'} "
                                   f"after step {i} (lr 0 at count 0, then the warmup's)")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        Trainer.training_step = step
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            expr = TT.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
            t_fit = time.perf_counter() - t0
        finally:
            Trainer.training_step = real_step
        peak = torch.cuda.max_memory_allocated()
        train_counts = read_counts()
        trainer = st["trainer"]
        flops = train_step_flops(torch, trainer, st["batch"])
        ends = [t0] + st["ends"]
        wall_ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
        step_ms = [s[0] for s in st["steps"]]
        frames = [s[1] for s in st["steps"]]
        for i, ((ms, n, mel, tok), wall, vals) in enumerate(zip(st["steps"], wall_ms,
                                                                 st["losses"])):
            print(f"[tts_train] step {i + 1}: {ms:.1f} ms in the step, {wall:.1f} ms since the "
                  f"last (data included); mel {mel}, tokens {tok}, {n} valid frames; losses "
                  + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
        ms, wall = statistics.median(step_ms[1:]), statistics.median(wall_ms[1:])
        rate = sum(frames[1:]) / (sum(step_ms[1:]) / 1e3)
        wall_rate = sum(frames[1:]) / (sum(wall_ms[1:]) / 1e3)
        bound = flops / PEAK_OPS["f32"] * 1e3
        print(f"[tts_train] {TTS_TRAIN_STEPS} steps in {t_fit:.1f} s with set-up; per step "
              f"{ms:.1f} ms in the step (median of 2..{TTS_TRAIN_STEPS}), {wall:.1f} ms "
              f"between steps with the data wait; {rate:.0f} mel frames trained per second "
              f"({wall_rate:.0f} with the data wait); peak device memory {peak / 2**30:.2f} GiB; "
              f"step bound {bound:.1f} ms ({flops / 1e12:.2f} TFLOP forward and backward on "
              f"the padded shapes over {PEAK_OPS['f32'] / 1e12:g} TFLOP/s f32), "
              f"{bound / ms:.3f} of it reached; fused attention launches in training "
              f"{train_counts['fused_attention']} ({gpu_line})", flush=True)

        # the checkpoint the run wrote, through the eval interfaces
        ckpt = ExperimentSaver.get_last_checkpoint(expr)
        check(ckpt is not None and ckpt.name == f"step_{TTS_TRAIN_STEPS:09d}",
              f"tts_train: last checkpoint {ckpt}")
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt,
                                                    device="cuda")
        speaker = ti.get_speakers()[0]
        ctx = ti.prepare_embeddings(ti.create_context("EN", speaker))
        opts = TTSOptions(t_out=T_FRAMES)
        gen = torch.Generator(device="cuda").manual_seed(0)
        sentences = list(TTS_TRAIN_REQUEST)
        inputs = ti.prepare_batch(sentences, ctx, opts)
        noise = torch.randn(ti.model.noise_shape(inputs, T_FRAMES), generator=gen,
                            device="cuda") * ti.model.decoder.temperature
        _, voc_params = serving.flagship_params()
        vm = seeded_vocoder(torch, voc_params)
        vi = VocoderEvaluationInterface(vm.to("cuda"))
        # f32: the reloaded checkpoint through the kernels against the trained model in
        # memory through the plain versions, on the same request and noise, each one's
        # valid frames then through the vocoder, with its kernels and with its plain versions
        # train_tts trained a G2P into the experiment, and the reloaded interface found it
        check(isinstance(ti.text_processor.parser, G2PParserHook),
              "tts_train: the reloaded checkpoint does not serve through the run's g2p.pkl")
        trained = TTSEvaluationInterface(trainer.model, payload,
                                         text_parser=ti.text_processor.parser)
        got = tts_request(torch, ti, vi, sentences, ctx, opts, noise=noise)
        with plain_versions():
            ref = tts_request(torch, trained, vi, sentences, ctx, opts, noise=noise)
        check(torch.equal(got["out"].attention.sum(1), ref["out"].attention.sum(1)),
              "tts_train f32: durations differ (reloaded with kernels, trained with plain)")
        spec_k, spec_p = got["out"].spectrogram, ref["out"].spectrogram
        mel_err, mel_lim = (spec_k - spec_p).abs().max().item(), rel_limit(spec_p)
        var_err = worst_rel(got["out"].variance_predictions, ref["out"].variance_predictions)
        wav_err = float(np.abs(got["wave"] - ref["wave"]).max())
        wav_lim = TOL_F32_REL * float(np.abs(ref["wave"]).max())
        # a model this young predicts no frame for a token (each utterance is floored at
        # one empty frame), so its mel does not see the encoder and the CFM attends to
        # one key: the last training batch, teacher-forced and deterministic under
        # inference mode, holds the fused attention at that batch's masks (encoder
        # 40 x 128 tokens, the CFM estimator once over 40 x 960 frames), and the
        # vocoder its first utterance's valid frames
        last = st["batch"]
        tf_in = _on(TTSBatchProcessor()(last)[0], "cuda")
        tf_draws = ti.model.decoder.draw(tf_in.mel.shape[0], tf_in.mel.shape, torch.device("cuda"),
                                         torch.Generator(device="cuda").manual_seed(1))
        tf = []
        for mode, model in ((contextlib.nullcontext(), ti.model),
                            (plain_versions(), trained.model)):
            with mode, torch.inference_mode():
                o = model(tf_in, training=True, deterministic=True, cfm_draws=tf_draws)
            tf.append(dict(spectrogram=o.spectrogram, gate=o.gate, **o.variance_predictions,
                           **o.additional_losses))
        tf_err = worst_rel(*tf)
        target = torch.as_tensor(last.mel[0, :int(last.mel_lengths[0])], device="cuda")
        utt_k = vi.synthesize(target).data
        with plain_versions():
            utt_p = vi.synthesize(target).data
        utt_err = float(np.abs(utt_k - utt_p).max())
        utt_lim = TOL_F32_REL * float(np.abs(utt_p).max())
        print(f"[tts_train] {ckpt.name} -> load_checkpoint -> TTSEvaluationInterface, f32: "
              f"{len(sentences)} sentences, {sum(got['lens'])} frames; the reloaded model "
              f"with the kernels against the trained model in memory with the plain "
              f"versions: mel max_abs_err {mel_err:.3g} (tol {mel_lim:.3g}), variance "
              f"predictions {var_err:.3g} of scale, wave max_abs_err {wav_err:.3g} (tol "
              f"{wav_lim:.3g}); the training batch {tuple(tf_in.mel.shape)} teacher-forced: "
              f"outputs and cfm loss {tf_err:.3g} of scale (tol {TOL_F32_REL:g}); the "
              f"vocoder on a training utterance's {target.shape[0]} frames, kernels vs "
              f"plain: max_abs_err {utt_err:.3g} (tol {utt_lim:.3g})", flush=True)
        check(mel_err <= mel_lim and wav_err <= wav_lim and utt_err <= utt_lim
              and max(var_err, tf_err) <= TOL_F32_REL,
              "tts_train f32: the reloaded checkpoint with the kernels disagrees with the "
              "trained model with the plain versions")
        del got, ref, spec_k, spec_p, trained, trainer, st["trainer"], st["batch"], last, target
        del tf_in, tf_draws, tf, o

        ti = TTSEvaluationInterface(ti.model.to(torch.bfloat16), payload,
                                    text_parser=ti.text_processor.parser)
        vm.to(torch.bfloat16)
        reset_counts()
        r = tts_request(torch, ti, vi, sentences, ctx, opts, gen=gen)
        request_counts = read_counts()
        check(request_counts == EXPECTED_LAUNCHES,
              f"tts_train: the reloaded request's launches {request_counts} != "
              f"{EXPECTED_LAUNCHES}")
        wave, lens = r["wave"], r["lens"]
        check(wave.shape == ((sum(lens) - 1) * HOP,) and bool(np.isfinite(wave).all()),
              f"tts_train: waveform {wave.shape}, finite {np.isfinite(wave).all()}")
        ms_r = r["ms"]
        print(f"[tts_train] the reloaded checkpoint serves (bf16, first call): "
              f"{len(TTS_TRAIN_REQUEST)} sentences, tokens "
              f"{tuple(r['inputs'].transcription.shape)}, frames {lens} -> "
              f"{len(wave) / SR:.3f} s audio (std {float(wave.std()):.3g}); frontend "
              f"{ms_r['frontend']:.1f} ms, acoustic {ms_r['acoustic']:.1f} ms, vocoder "
              f"{ms_r['vocoder']:.1f} ms; launches {request_counts}", flush=True)
        del ti, vi, vm, r
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[tts_train] phase wall time {phase_s:.1f} s", flush=True)
    launches = {k: train_counts[k] + request_counts[k] for k in train_counts}
    res.update(launches=launches, ms=ms, wall_ms=wall, frame_rate=rate,
               wall_frame_rate=wall_rate, peak=peak, bound_ms=bound, phase_s=phase_s)
    return res


# -- phase 12: XTTS training --------------------------------------------------------

XTTS_TRAIN_PRESET = "default"
XTTS_TRAIN_STEPS = 3  # the cut: B32, B8, then a full B32
# a training step: the prompt encoder's 4 blocks, each one fused-attention forward (its
# backward is the torch-op VJP, no launch); the GPT's causal attention is plain einsum
XTTS_TRAIN_LAUNCHES = {"fused_attention": 4, "anti_alias_snake": 0, "aa_upsample_fir": 0,
                       "aa_snake_downsample": 0}
XTTS_VJP_SHAPE = (32, 112, 4, 256)  # B32 of 448-frame prompts at stride 4, 4 heads of 256
TOL_VJP_F32 = 5e-5  # the kernels phase's f32 attention tolerance, on the forward and the VJP


def check_attention_vjp(torch, A, gpu_line: str) -> dict:
    """The fused-attention autograd Function at the training path's shape (f32): one
    forward launch, its output and q, k and v's gradients against PyTorch autograd of
    the plain version within ``TOL_VJP_F32`` (the padded query rows' outputs are zeros
    on both sides); then the forward kernel's and the VJP's ms a call (CUDA events),
    and the plain version's backward for comparison."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, t, h, dh = XTTS_VJP_SHAPE
    # ragged rows (112, then 13 fewer a row), 1e4-scale values in the padded ones
    lens = torch.tensor([max(1, t - 13 * (i % 9)) for i in range(b)], device="cuda")
    valid = torch.arange(t, device="cuda")[None] < lens[:, None]
    q, k, v, g = (torch.randn(XTTS_VJP_SHAPE, generator=gen, device="cuda") for _ in range(4))
    for x in (q, k, v):
        x[~valid] *= 1e4
    outs, grads = [], []
    before = A.fused_attention.launches
    # the kernel reads the blocks' mask[:, 0, 0, :] view, as on the path
    for fn, mask in ((A.fused_attention, _strided(torch, valid)), (A.attention_reference, valid)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, mask)
        out.backward(g)
        outs.append(out.detach())
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    check(A.fused_attention.launches == before + 1, "attention VJP: the forward did not launch "
                                                    "the kernel once")
    fwd_err = (outs[0] - outs[1]).abs().max().item()
    padded_max = outs[0][~valid].abs().max().item()
    err = max((u - w).abs().max().item() for u, w in zip(*grads))
    scale = max(w.abs().max().item() for w in grads[1])
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: A.fused_attention(q, k, v, valid), 20)
        vjp_ms = cuda_ms(lambda: A.fused_attention_vjp(q, k, v, valid, g), 20)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = A.attention_reference(*leaves, valid)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), 20)
    print(f"[xtts_train] attention VJP B{b} T{t} H{h} dh{dh} f32 (ragged, 1e4 in padded rows): "
          f"forward vs plain max_abs_err {fwd_err:.3g} (largest in padded query rows "
          f"{padded_max:.3g}), q, k, v gradients vs plain autograd max_abs_err {err:.3g} "
          f"(tol {TOL_VJP_F32:g}; largest gradient {scale:.3g}); forward kernel {fwd_ms:.4f} ms, "
          f"VJP {vjp_ms:.4f} ms, plain backward {plain_ms:.4f} ms a call ({gpu_line})", flush=True)
    check(fwd_err <= TOL_VJP_F32, f"attention forward f32 B{b}: {fwd_err} > {TOL_VJP_F32}")
    check(padded_max == 0.0, f"attention forward f32 B{b}: padded query rows not zero "
                             f"({padded_max})")
    check(err <= TOL_VJP_F32, f"attention VJP f32: {err} > {TOL_VJP_F32}")
    n = XTTS_TRAIN_LAUNCHES["fused_attention"]
    return {"vjp_err": err, "train_fwd_err": fwd_err, "train_fwd_ms": n * fwd_ms,
            "vjp_ms": n * vjp_ms, "vjp_plain_ms": n * plain_ms}


@contextlib.contextmanager
def pinned_codes(model, codes):
    """``model.codec.encode`` returning ``codes`` (on the model's device): both sides
    of a comparison train on the same targets."""
    model.codec.encode = lambda wav: codes.to(wav.device)
    try:
        yield
    finally:
        del model.codec.encode


@contextlib.contextmanager
def planted_vjp_fault(A):
    """``fused_attention_vjp`` with dq and dk exchanged (an einsum's operands swapped),
    a fault that keeps every shape and the dv gradient."""
    real = A.fused_attention_vjp
    A.fused_attention_vjp = lambda *args: (lambda dq, dk, dv: (dk, dq, dv))(*real(*args))
    try:
        yield
    finally:
        A.fused_attention_vjp = real


def xtts_step_grads(torch, model, inputs) -> tuple:
    """``gpt_ce`` and its gradients on the CPU: ({loss: value}, {parameter: gradient})."""
    for p in model.parameters():
        p.grad = None
    loss = model(inputs)["gpt_ce"]
    loss.backward()
    return ({"gpt_ce": loss.item()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()})


def xtts_gate(torch, model_cfg: dict, data_cfg: dict) -> dict:
    """One f32 XTTS step at the recipe's full width on the card and on the CPU: the
    same weights (flax's initialisers from ``torch.manual_seed(0)``), the first two
    train utterances through the prompt collate, the codes the CPU's codec encodes
    given to both sides (``pinned_codes``; a code is an argmin, and the card's own
    codes are counted where they differ); TF32 off. No reference gradient is all zero
    but the codec's (it is reached through integer codes only); ``gpt_ce`` within
    ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD`` (``tts_disagreement``);
    the same gate must reject a planted fault of the attention VJP (``planted_vjp_fault``)."""
    import copy

    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.ops import attention as A
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.training.trainer import _place

    t0 = time.perf_counter()
    pipeline = DataPipeline.from_config(TT.data_config_of(model_cfg, data_cfg))
    torch.manual_seed(0)
    _, cpu, _, bp = TT.build_model(model_cfg, pipeline)
    card = copy.deepcopy(cpu).to("cuda")
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    inputs, _ = bp(batch)
    with torch.no_grad():
        codes = cpu.codec.encode(inputs["waveform"])
        own = card.codec.encode(inputs["waveform"].to("cuda")).cpu()
    flips = int((own != codes).sum())
    with pinned_codes(cpu, codes):
        ref = xtts_step_grads(torch, cpu, inputs)
    zero = [k for k, v in ref[1].items() if not v.any()]
    check(zero and all(k.startswith("codec.") for k in zero)
          and all(not v.any() for k, v in ref[1].items() if k.startswith("codec.")),
          f"xtts_train: reference gradients all zero beyond the codec's: "
          f"{[k for k in zero if not k.startswith('codec.')]}")
    card_in = _place(inputs, torch.device("cuda"))
    before = A.fused_attention.launches
    with pinned_codes(card, codes):
        got = xtts_step_grads(torch, card, card_in)
        launched = A.fused_attention.launches - before
        with planted_vjp_fault(A):
            bad = xtts_step_grads(torch, card, card_in)
    check(launched == XTTS_TRAIN_LAUNCHES["fused_attention"],
          f"xtts_train gate: {launched} fused attention launches in one step")
    loss_err, grad_err, where = tts_disagreement(ref, got)
    f_loss, f_grad, f_where = tts_disagreement(ref, bad)
    prompt = tuple(inputs["prompt_mel"].shape)
    print(f"[xtts_train] f32 step at full width, card vs CPU (flax's initialisers, B2, "
          f"waveform {tuple(inputs['waveform'].shape)}, codes {tuple(codes.shape)}, tokens "
          f"{tuple(inputs['transcription'].shape)}, prompt mel {prompt}, TF32 off, codes "
          f"pinned to the CPU's; {time.perf_counter() - t0:.1f} s): gpt_ce "
          f"{got[0]['gpt_ce']:.6g} (CPU {ref[0]['gpt_ce']:.6g}), error {loss_err:.3g} of it "
          f"(tol {TOL_F32_REL:g}); {len(ref[1])} gradients, worst {grad_err:.3g} of scale "
          f"({where}; tol {TOL_TTS_GRAD:g}); codes the card's own encode would have "
          f"flipped: {flips} of {codes.numel()}; {len(zero)} codec gradients all zero on "
          f"the CPU; fused attention launches {launched}", flush=True)
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"xtts_train f32: the card disagrees with the CPU: loss {loss_err}, {where} {grad_err}")
    print(f"[xtts_train] planted fault (the attention VJP's dq and dk exchanged): worst loss error {f_loss:.3g}, worst gradient {f_grad:.3g} of scale "
          f"({f_where})", flush=True)
    check(f_grad > TOL_TTS_GRAD, "the xtts_train gate passes a planted fault of the VJP")
    del cpu, card, got, ref, bad
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_err": grad_err, "fault_grad_err": f_grad,
            "code_flips": flips}


def phase_xtts_train(torch, gpu_line: str) -> dict:
    """XTTS training through the port's entry point, then the checkpoint served through
    ``XTTSEvaluationInterface``."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.ops import attention as A
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.lr_schedulers import build_lr_schedule
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg, data_cfg = TT.configs(XTTS_TRAIN_PRESET, "configs/xtts_model.yml")
    data_cfg["dirs"]["data_root"] = str(REPO / "tests" / "data" / "SEGS")
    model_cfg["trainer"]["max_steps"] = XTTS_TRAIN_STEPS
    opt = model_cfg["optimizer"]
    lr0 = build_lr_schedule(opt["lr_schedule"], opt["lr"], **opt["lr_schedule_kwargs"])(0)
    check(lr0 == 0.0, f"xtts_train: the schedule's lr at count 0 is {lr0}, not 0")
    res = {"times": {"fused_attention": check_attention_vjp(torch, A, gpu_line)},
           "gate": xtts_gate(torch, model_cfg, data_cfg)}

    st = {"ref": None, "steps": [], "ends": [], "losses": [], "trainer": None, "batch": None}
    real_step = Trainer.training_step

    def step(self, batch):
        """The trainer's step, timed (synchronised), with its fused-attention launches;
        the last full batch is kept for the FLOP count."""
        if st["ref"] is None:
            st["ref"] = [p.detach().clone() for p in self.model.parameters()]
        torch.cuda.synchronize()
        n0 = A.fused_attention.launches
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        st["steps"].append((1e3 * (time.perf_counter() - t0), A.fused_attention.launches - n0,
                            int((batch.waveform_lengths // HOP).sum()),
                            tuple(batch.waveform.shape), tuple(batch.transcription.shape),
                            tuple(batch.additional["prompt_mel"].shape)))
        if batch.waveform.shape[0] == model_cfg["batch"]["size"]:
            st["batch"] = batch
        return out

    def callback(trainer, last):
        torch.cuda.synchronize()
        st["ends"].append(time.perf_counter())
        st["trainer"] = trainer
        i = trainer.global_step
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()), f"xtts_train: non-finite loss {vals}")
        check(st["steps"][-1][1] == XTTS_TRAIN_LAUNCHES["fused_attention"],
              f"xtts_train: {st['steps'][-1][1]} fused attention launches in step {i}")
        changed = any(not torch.equal(p, r)
                      for p, r in zip(trainer.model.parameters(), st["ref"]))
        check(changed == (i >= 2), f"xtts_train: weights {'changed' if changed else 'unchanged'} "
                                   f"after step {i} (lr 0 at count 0, then the warmup's)")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        Trainer.training_step = step
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            expr = TT.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
            t_fit = time.perf_counter() - t0
        finally:
            Trainer.training_step = real_step
        peak = torch.cuda.max_memory_allocated()
        train_counts = read_counts()
        ends = [t0] + st["ends"]
        wall_ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
        step_ms = [s[0] for s in st["steps"]]
        tokens = [s[2] for s in st["steps"]]
        for i, ((ms, n, tok, wav, text, prompt), wall, vals) in enumerate(
                zip(st["steps"], wall_ms, st["losses"])):
            print(f"[xtts_train] step {i + 1}: {ms:.1f} ms in the step, {wall:.1f} ms since the "
                  f"last (data included); waveform {wav}, tokens {text}, prompt mel {prompt}, "
                  f"{tok} audio tokens; {n} fused attention launches; losses "
                  + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()), flush=True)
        # the sampler serves the 40 train utterances as a batch of 32, then one of 8
        full = [i for i, s in enumerate(st["steps"]) if i and s[3][0] == model_cfg["batch"]["size"]]
        check(full, "xtts_train: no full batch after the first step")
        ms = statistics.median(step_ms[i] for i in full)
        wall = statistics.median(wall_ms[i] for i in full)
        ms_all = statistics.median(step_ms[1:])
        rate = sum(tokens[1:]) / (sum(step_ms[1:]) / 1e3)
        wall_rate = sum(tokens[1:]) / (sum(wall_ms[1:]) / 1e3)
        vjp = res["times"]["fused_attention"]
        flops = train_step_flops(torch, st["trainer"], st["batch"])
        bound = flops / PEAK_OPS["f32"] * 1e3
        print(f"[xtts_train] {XTTS_TRAIN_STEPS} steps in {t_fit:.1f} s with set-up; a step of "
              f"B{model_cfg['batch']['size']} {ms:.1f} ms in the step (median of steps "
              f"{[i + 1 for i in full]}), {wall:.1f} ms since the step before it (data "
              f"wait included); every step of 2..{XTTS_TRAIN_STEPS} {ms_all:.1f} ms (median); "
              f"{rate:.0f} audio tokens trained per second in the steps 2..{XTTS_TRAIN_STEPS} "
              f"({wall_rate:.0f} with the data wait); peak device memory {peak / 2**30:.2f} GiB; "
              f"B{model_cfg['batch']['size']} step bound {bound:.1f} ms ({flops / 1e12:.2f} TFLOP "
              f"forward and backward on the padded shapes over {PEAK_OPS['f32'] / 1e12:g} "
              f"TFLOP/s f32), {bound / ms:.3f} of it reached; "
              f"fused attention launches per step {XTTS_TRAIN_LAUNCHES['fused_attention']} "
              f"(forward {vjp['train_fwd_ms']:.3f} ms, VJP {vjp['vjp_ms']:.3f} ms, plain "
              f"backward {vjp['vjp_plain_ms']:.3f} ms a step); {gpu_line}", flush=True)

        # the checkpoint the run wrote, through the XTTS interface
        ckpt = ExperimentSaver.get_last_checkpoint(expr)
        check(ckpt is not None and ckpt.name == f"step_{XTTS_TRAIN_STEPS:09d}",
              f"xtts_train: last checkpoint {ckpt}")
        del st["trainer"], st["batch"]
        xi = XTTSEvaluationInterface(ckpt, device="cuda")
        wave = prompt_wave()
        xtts_kernels_vs_plain(torch, xi, wave)
        reset_counts()
        t0 = time.perf_counter()
        out = xi.synthesize(REQUEST_SENTENCES[0], speaker=xi.get_speakers()[0],
                            max_tokens=XTTS_GREEDY_TOKENS, temperature=0.8, seed=0,
                            ref_audio=AudioChunk(data=wave, sr=SR))
        request_ms = 1e3 * (time.perf_counter() - t0)
        request_counts = read_counts()
        check(request_counts == XTTS_LAUNCHES,
              f"xtts_train: the reloaded request's launches {request_counts} != {XTTS_LAUNCHES}")
        check(out.data.shape == (XTTS_GREEDY_TOKENS * HOP,) and bool(np.isfinite(out.data).all()),
              f"xtts_train: waveform {out.data.shape}, finite {np.isfinite(out.data).all()}")
        print(f"[xtts_train] {ckpt.name} -> XTTSEvaluationInterface serves a request of "
              f"{XTTS_GREEDY_TOKENS} tokens (f32, first call) in {request_ms:.1f} ms; "
              f"launches {request_counts}", flush=True)
        del xi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[xtts_train] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    launches = {k: train_counts[k] + request_counts[k] for k in train_counts}
    res.update(launches=launches, ms=ms, ms_all=ms_all, wall_ms=wall, token_rate=rate,
               wall_token_rate=wall_rate, peak=peak, bound_ms=bound, phase_s=phase_s)
    return res


# -- phases 13 and 14: the prosody model and the conditioned inference chain -----------

PROSODY_TRAIN_PRESET = "default"
PROSODY_TRAIN_STEPS = 20
# the prosody model's inference call: 4 blocks, one attention launch each, per sentence
PROSODY_LAUNCHES = 4
TOL_PROSODY_GRAD = 1e-3  # a card-vs-CPU f32 step's gradients, of each tensor's scale
REF_WAV = (REPO / "tests" / "data" / "SRC" / "EN" / "OPENSOURCE_VOICES" / "001_LJSpeech" /
           "LJSpeech-1.1" / "wavs" / "LJ001-0002.wav")
SEGS = REPO / "tests" / "data" / "SEGS"
COND_SENTENCES = REQUEST_SENTENCES[:8]  # the conditioned request: 8 sentences, 1..11 words
COND_REQUESTS = 1  # timed requests after the first
COND_OVERRIDES = dict(use_prosody=True, speaker_emb_mode="input", speaker_bio_dim=192,
                      use_style_encoder=True, style_use_vae=True, style_use_gmvae=False)
TOL_ECAPA = 1e-4  # the ECAPA embedding on the card against the CPU's
TOL_PRIOR = 1e-6  # GMVAE prior draws on the card against the CPU's, of their scale


def prosody_gate(torch, model_cfg: dict) -> dict:
    """One f32 step of the preset's model (seeded, dropout off) on the card and on the
    CPU on the same SEGS batch: the losses within ``TOL_F32_REL``, every gradient within
    ``TOL_PROSODY_GRAD`` of its tensor's scale (or 1e-3 of the model's largest)."""
    import copy

    from speechflow_torch.models.prosody import ProsodyCriterion, ProsodyModel, ProsodyParams
    from speechflow_torch.ops import attention as A
    from speechflow_torch.scripts import train_prosody as TP

    params = ProsodyParams.create(dict(model_cfg["model"], dropout=0.0))
    torch.manual_seed(1)
    cpu = ProsodyModel(params)
    gpu = copy.deepcopy(cpu).cuda()
    loader = TP.ProsodySampleLoader(str(SEGS), params.vocab_size,
                                    batch_size=int(model_cfg["batch"]["size"]))
    inputs, targets = TP.prosody_batch(loader.next_batch())
    res = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        y = {k: torch.from_numpy(v).to(dev) for k, v in targets.items()}
        before = A.fused_attention.launches
        losses = ProsodyCriterion()(model(x), y, 0)
        sum(losses.values()).backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            check(A.fused_attention.launches - before == params.n_layers,
                  "prosody_train gate: the card's step did not launch the kernel per block")
        res.append(({k: v.item() for k, v in losses.items()},
                    {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6) for k in l_cpu)
    model_scale = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, ref in g_cpu.items():
        scale = max(ref.abs().max().item(), 1e-3 * model_scale)
        err = (g_gpu[name] - ref).abs().max().item() / scale
        if err > worst:
            worst, worst_name = err, name
    print(f"[prosody_train] f32 step card vs CPU (B{inputs['token_ids'].shape[0]} "
          f"T{inputs['token_ids'].shape[1]}, dropout 0): losses {l_gpu} vs {l_cpu}, rel err "
          f"{loss_err:.3g} (tol {TOL_F32_REL:g}); worst gradient {worst_name} {worst:.3g} of "
          f"its scale (tol {TOL_PROSODY_GRAD:g})", flush=True)
    check(loss_err <= TOL_F32_REL, f"prosody_train gate: losses differ {l_gpu} {l_cpu}")
    check(worst <= TOL_PROSODY_GRAD, f"prosody_train gate: gradient {worst_name} {worst}")
    return {"loss_rel_err": loss_err, "grad_rel_err": worst}


def prosody_kernels_vs_plain(torch, pi, sentences) -> dict:
    """The reloaded prosody interface on the card through the kernels and the plain
    versions: logits within ``TOL_F32_REL`` of their scale and the same classes; and
    the ms a sentence (the kernels; 4 launches)."""
    import numpy as np

    worst, ms = 0.0, []
    for sent in sentences:
        words = sent.split()
        before = read_counts()["fused_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = pi.predict(words)
        ms.append(1e3 * (time.perf_counter() - t0))
        check(read_counts()["fused_attention"] - before == PROSODY_LAUNCHES,
              "prosody: a sentence did not launch the kernel once a block")
        got = pi.logits(words)
        with plain_versions():
            ref = pi.logits(words)
            pred_p = pi.predict(words)
        for head in ("binary", "category"):
            g, r = got[head][0, :len(words)], ref[head][0, :len(words)]
            err = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-6)
            worst = max(worst, err)
            check(err <= TOL_F32_REL, f"prosody: {head} logits kernels vs plain {err}")
        for k in pred:
            check(np.array_equal(pred[k], pred_p[k]), f"prosody: {k} differs (kernels, plain)")
    return {"logit_rel_err": worst, "ms": float(np.median(ms)), "first_ms": ms[0]}


def phase_prosody_train(torch, gpu_line: str) -> dict:
    """The prosody model trained through the port's ``train_prosody.train`` at the
    default preset (256 x 4 x 4, vocab 8000, batch 64, ``tokenizer: word_lm``) on
    ``tests/data/SEGS`` for ``PROSODY_TRAIN_STEPS`` steps, then served."""
    import tempfile

    import numpy as np

    from speechflow_torch.models.prosody import ProsodyPredictionInterface
    from speechflow_torch.scripts import train_prosody as TP
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg = TP.configs(PROSODY_TRAIN_PRESET)[0]
    model_cfg["trainer"].update(max_steps=PROSODY_TRAIN_STEPS, log_every=5,
                                ckpt_every=PROSODY_TRAIN_STEPS)
    res = {"gate": prosody_gate(torch, model_cfg)}

    st = {"lm_s": [], "words": [], "ends": [], "losses": []}
    real_lm, real_loader = TP.train_word_lm, TP.ProsodySampleLoader

    def timed_lm(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm = real_lm(*args, **kwargs)
        torch.cuda.synchronize()
        st["lm_s"].append(time.perf_counter() - t0)
        st["lm_vocab"] = len(lm.vocab)
        return lm

    class CountingLoader(real_loader):
        def next_batch(self):
            batch = super().next_batch()
            st["words"].append(int(batch["lengths"].sum()))
            return batch

    def callback(trainer, last):
        st["losses"].append(float(last["total_loss"]))  # fetches: synchronised
        st["ends"].append(time.perf_counter())

    base = Path(tempfile.mkdtemp(prefix="prosody_", dir=workdir()))
    saver = experiment_saver(model_cfg, {"dirs": {"data_root": str(SEGS)}}, base)
    TP.train_word_lm, TP.ProsodySampleLoader = timed_lm, CountingLoader
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        expr = TP.train(model_cfg, SEGS, saver, device="cuda", callbacks=[callback])
        train_s = time.perf_counter() - t0
    finally:
        TP.train_word_lm, TP.ProsodySampleLoader = real_lm, real_loader
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(st["losses"]) == PROSODY_TRAIN_STEPS and all(np.isfinite(st["losses"])),
          f"prosody_train: losses {st['losses']}")
    check(train_counts["fused_attention"] == PROSODY_LAUNCHES * PROSODY_TRAIN_STEPS,
          f"prosody_train: {train_counts} launches for {PROSODY_TRAIN_STEPS} steps")
    steps_ms = 1e3 * np.diff(st["ends"])  # step i+1 ends minus step i ends
    ms = float(np.median(steps_ms))
    words = float(np.mean(st["words"]))
    print(f"[prosody_train] WordLM: {st['lm_vocab']} words trained in {st['lm_s'][0]:.2f} s on "
          f"the card; {PROSODY_TRAIN_STEPS} steps at B{model_cfg['batch']['size']} in "
          f"{train_s:.1f} s (WordLM included); losses {st['losses'][0]:.4f} -> "
          f"{st['losses'][-1]:.4f}; {ms:.2f} ms a step (median from step 2, between step "
          f"ends; first {1e3 * (st['ends'][0] - t0 - st['lm_s'][0]):.1f} ms after the WordLM), "
          f"{words / (ms / 1e3):.0f} words trained a second; peak memory {peak:.2f} GiB; "
          f"fused attention launches {train_counts['fused_attention']}; {gpu_line}", flush=True)

    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    check(ckpt is not None and ckpt.name == f"step_{PROSODY_TRAIN_STEPS:09d}",
          f"prosody_train: last checkpoint {ckpt}")
    check((Path(expr) / "word_lm.pkl").is_file(), "prosody_train: no word_lm.pkl")
    pi = ProsodyPredictionInterface(ckpt)
    check(pi.vocab is not None and len(pi.vocab) == st["lm_vocab"],
          "prosody_train: the checkpoint lacks the WordLM vocabulary")
    reset_counts()
    served = prosody_kernels_vs_plain(torch, pi, COND_SENTENCES)
    serve_counts = read_counts()
    print(f"[prosody_train] {ckpt.name} -> ProsodyPredictionInterface on the card: "
          f"{len(COND_SENTENCES)} sentences, logits kernels vs plain rel err "
          f"{served['logit_rel_err']:.3g} (tol {TOL_F32_REL:g}), classes equal; "
          f"{served['ms']:.2f} ms a sentence (median; first {served['first_ms']:.1f} ms)",
          flush=True)
    _WORK["prosody_ckpt"] = ckpt
    del pi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[prosody_train] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    launches = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    res.update(launches=launches, ms=ms, lm_s=st["lm_s"][0], words_per_s=words / (ms / 1e3),
               peak=peak, predict_ms=served["ms"], phase_s=phase_s)
    return res


def prosody_checkpoint(torch) -> Path:
    """The checkpoint ``prosody_train`` wrote in this run, else one of the default
    preset's model from flax's initialisers (seed 0), hash tokens."""
    if "prosody_ckpt" not in _WORK:
        import dataclasses

        from speechflow_torch.convert import nnx_from_module
        from speechflow_torch.models.prosody import ProsodyModel, ProsodyParams
        from speechflow_torch.scripts import train_prosody as TP
        from speechflow_torch.training.saver import ExperimentSaver

        params = ProsodyParams.create(dict(TP.configs(PROSODY_TRAIN_PRESET)[0]["model"],
                                           tokenizer="hash"))
        torch.manual_seed(0)
        saver = ExperimentSaver(workdir(), expr_suffix="prosody")
        saver.to_save["model_params"] = dataclasses.asdict(params)
        _WORK["prosody_ckpt"] = saver.save(0, nnx_from_module(ProsodyModel(params)))
    return _WORK["prosody_ckpt"]


def conditioned_payload() -> dict:
    """The flagship payload of the char fallback's symbols with the conditioned
    options, and the ``MeanBioEmbeddings`` of the SEGS train split: each utterance
    loaded at 24 kHz through the ported ``voice_biometrics`` (with the biometric
    model that is set), then fitted."""
    import dataclasses

    from speechflow_torch import serving
    from speechflow_torch.data.parsers import TTSDSParser
    from speechflow_torch.data.processors.audio import load_audio
    from speechflow_torch.data.processors.embeddings import voice_biometrics
    from speechflow_torch.data.processors.singletons import MeanBioEmbeddings
    from speechflow_torch.io.flist import construct_file_list, split_file_list
    from speechflow_torch.scripts import train_tts as TT

    payload = serving.flagship_payload(request_symbols())
    payload["model_params"] = dataclasses.asdict(serving.ParallelTTSParams.create(
        dict(payload["model_params"], **COND_OVERRIDES)))
    ds_cfg = TT.configs("default")[1]["dataset"]
    files = construct_file_list(SEGS, ext=".TextGridStage3")
    train, _ = split_file_list(files, float(ds_cfg["split_ratio"]), int(ds_cfg["seed"]))
    samples = TTSDSParser(max_duration=10.0, min_duration=0.5).read_datasamples(train)
    t0 = time.perf_counter()
    for ds in samples:
        voice_biometrics(load_audio(ds, sample_rate=SR))
    fit_s = time.perf_counter() - t0
    mean = MeanBioEmbeddings().fit(samples)
    payload["pipeline_info"]["singletons"]["MeanBioEmbeddings"] = mean.state_dict()
    print(f"[conditioned] MeanBioEmbeddings over the SEGS train split: {len(samples)} "
          f"utterances through voice_biometrics (ECAPA on the card) in {fit_s:.1f} s, "
          f"{len(mean.mean_emb)} speakers", flush=True)
    return payload


def cond_request(torch, ti, vi, sentences, opts, timers, gen=None, noise=None) -> dict:
    """One conditioned request as ``synthesize`` composes it, timed part by part (the
    host clock, synchronised): the reference (wav load, ECAPA, style mel), the text
    frontend (prosody prediction inside), the acoustic model, the vocoder."""
    for v in timers.values():
        v.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = ti.prepare_embeddings(ti.create_context("EN"), REF_WAV)
    t1 = time.perf_counter()
    inputs = ti.prepare_batch(sentences, ctx, opts)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = ti.evaluate(inputs, opts, noise=noise, generator=gen)
    mel, lens = _valid_mel(out)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    audio = vi.synthesize(mel)
    t4 = time.perf_counter()
    ecapa, prosody = sum(timers["ecapa"]), sum(timers["prosody"])
    return {"inputs": inputs, "out": out, "mel": mel, "lens": lens, "wave": audio.data,
            "ms": {"ecapa": ecapa, "reference_host": 1e3 * (t1 - t0) - ecapa,
                   "prosody": prosody, "frontend_host": 1e3 * (t2 - t1) - prosody,
                   "acoustic": 1e3 * (t3 - t2), "vocoder": 1e3 * (t4 - t3),
                   "total": 1e3 * (t4 - t0)}}


def _timed(torch, fn, sink: list):
    """``fn``, appending the ms of each call (synchronised) to ``sink``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(1e3 * (time.perf_counter() - t0))
        return out
    return wrapper


def _check_wave(what: str, wave, lens) -> float:
    import numpy as np

    check(wave.shape == ((sum(lens) - 1) * HOP,) and bool(np.isfinite(wave).all()),
          f"{what}: waveform {wave.shape}, finite {np.isfinite(wave).all()}")
    bounds = np.cumsum([0] + list(lens)) * HOP
    std = min(float(wave[a:b].std()) for a, b in zip(bounds[:-1], bounds[1:]))
    check(std > 1e-4, f"{what}: silent utterance (min std {std:.3g})")
    return std


def gmvae_prior_gate(torch, params, n: int, gpu_line: str) -> float:
    """A GMVAE style encoder at the acoustic model's style width (seeded, CPU, then a
    copy on the card): ``sample_prior`` on the card with component indices and normal
    draws from a card generator, against the CPU's on the same draws (within
    ``TOL_PRIOR`` of scale), then a draw from the generator alone. Returns the error."""
    import copy

    from speechflow_torch.models.tts.predictors import StyleEncoder

    torch.manual_seed(3)
    gm_cpu = StyleEncoder(params.n_mels, emb_dim=params.style_emb_dim, use_gmvae=True,
                          gmvae_n_components=params.style_gmvae_components).gmvae
    gm = copy.deepcopy(gm_cpu).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for sigma in (1.0, 0.5):
        idx = torch.randint(0, params.style_gmvae_components, (n,), generator=gen,
                            device="cuda")
        noise = torch.randn(n, params.style_emb_dim, generator=gen, device="cuda")
        with torch.no_grad():
            card = gm.sample_prior(n, sigma, idx=idx, noise=noise)
            ref = gm_cpu.sample_prior(n, sigma, idx=idx.cpu(), noise=noise.cpu())
        check(card.is_cuda and card.shape == (n, params.style_emb_dim),
              f"conditioned: sample_prior gave {tuple(card.shape)} on {card.device}")
        err = (card.cpu() - ref).abs().max().item()
        lim = TOL_PRIOR * ref.abs().max().item()
        check(err <= lim, f"conditioned: sample_prior card vs CPU {err} > {lim}")
        worst = max(worst, err)
        with torch.no_grad():
            drawn = gm.sample_prior(n, sigma, generator=gen)
        check(drawn.is_cuda and bool(torch.isfinite(drawn).all()),
              "conditioned: sample_prior from the generator alone")
        print(f"[conditioned] GMVAE sample_prior ({params.style_gmvae_components} components, "
              f"{params.style_emb_dim} dims, sigma {sigma}): {n} draws on the card vs the CPU "
              f"on the same indices and normals max_abs_err {err:.3g} (tol {lim:.3g}); "
              f"components {sorted(set(idx.tolist()))} ({gpu_line})", flush=True)
    return worst


def phase_conditioned(torch, gpu_line: str) -> dict:
    """The reference's whole inference chain at flagship width: the acoustic model with
    prosody classes, the projected speaker embedding and the style VAE (f32, flax's
    initialisers), the prosody model of ``prosody_train``, a seeded ECAPA on the card
    and the flagship vocoder; a text request with a reference wav, ``resynthesize``."""
    import math

    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.data.processors import embeddings as E
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.biometric import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams
    from speechflow_torch.utils.state_io import save_module

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the speaker embedder: seeded, default width, saved and set as the biometric model
    torch.manual_seed(1)
    ecapa_path = str(save_module(ECAPAEmbedder(ECAPAParams()), ECAPAParams(),
                                 workdir() / "ecapa.pkl"))
    hook, hook_cpu = E.make_ecapa_hook(ecapa_path), E.make_ecapa_hook(ecapa_path, device="cpu")
    check(next(hook.model.parameters()).is_cuda, "conditioned: the ECAPA hook is not on the card")
    ref_wave = AudioChunk(file_path=REF_WAV).load(sr=SR).waveform
    emb_gpu, emb_cpu = hook(ref_wave, SR), hook_cpu(ref_wave, SR)
    ecapa_err = float(np.abs(emb_gpu - emb_cpu).max())
    ecapa_ms = cuda_ms(lambda: hook(ref_wave, SR), 5)
    print(f"[conditioned] ECAPA (80 mels, 256 channels, 192 dims, 3 blocks) on "
          f"LJ001-0002.wav ({len(ref_wave) / SR:.2f} s): card vs CPU max_abs_err "
          f"{ecapa_err:.3g} (tol {TOL_ECAPA:g}); {ecapa_ms:.2f} ms a call on the card "
          f"(host mel included)", flush=True)
    check(ecapa_err <= TOL_ECAPA, f"conditioned: ECAPA card vs CPU {ecapa_err}")
    timers = {"ecapa": [], "prosody": []}
    E.set_biometric_model(_timed(torch, hook, timers["ecapa"]))
    try:
        payload = conditioned_payload()
        params = ParallelTTSParams.create(payload["model_params"])
        torch.manual_seed(0)
        am = ParallelTTSModel(params)
        with torch.no_grad():  # flax's zero bias would give every token 0 frames
            am.variance_adaptor.predictors["durations"].out.bias.fill_(
                math.log1p(serving.FRAMES_PER_TOKEN))
        am = am.to("cuda", torch.float32).eval()
        _, vm = serving.build_flagship("default", device="cuda", dtype=torch.float32, seed=0)
        ti = TTSEvaluationInterface(am, payload, prosody_ckpt=prosody_checkpoint(torch))
        vi = VocoderEvaluationInterface(vm)
        ti.prosody_interface.predict = _timed(torch, ti.prosody_interface.predict,
                                              timers["prosody"])
        opts = TTSOptions(t_out=T_FRAMES)
        sentences = list(COND_SENTENCES)
        print(f"[conditioned] built: acoustic model {params.encoder_dim} x "
              f"{params.encoder_layers} / DiT {params.decoder_dim} x {params.decoder_layers} "
              f"(prosody classes {params.n_prosody_classes}, speaker_bio_dim "
              f"{params.speaker_bio_dim}, style VAE {params.style_emb_dim}), f32, flax's "
              f"initialisers; prosody model {ti.prosody_interface.params.dim} x "
              f"{ti.prosody_interface.params.n_layers}; in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

        # kernels against plain on the same inputs (the kernels' prosody classes) and noise
        gen = torch.Generator(device="cuda").manual_seed(0)
        r0 = cond_request(torch, ti, vi, sentences, opts, timers, gen=gen)
        inputs = r0["inputs"]
        check(inputs.prosody is not None and bool((inputs.prosody[:, 0] == -1).all()),
              "conditioned: no prosody row (or a class on the BOS token)")
        noise = torch.randn(am.noise_shape(inputs, T_FRAMES), generator=gen,
                            device="cuda") * am.decoder.temperature
        outs = []
        for mode in (contextlib.nullcontext(), plain_versions()):
            with mode, torch.inference_mode():
                out = ti.evaluate(inputs, opts, noise=noise)
                mel, lens = _valid_mel(out)
                outs.append((out.attention.sum(1), mel, vi.synthesize(mel).data))
        (d_k, mel_k, wav_k), (d_p, mel_p, wav_p) = outs
        check(torch.equal(d_k, d_p), "conditioned f32: durations differ (kernels, plain)")
        mel_err, mel_lim = (mel_k - mel_p).abs().max().item(), rel_limit(mel_p)
        wav_err = float(np.abs(wav_k - wav_p).max())
        wav_lim = TOL_F32_REL * float(np.abs(wav_p).max())
        print(f"[conditioned] f32 {len(sentences)} sentences kernels vs plain: durations equal "
              f"({int(d_k.sum())} frames), mel max_abs_err {mel_err:.3g} (tol {mel_lim:.3g}), "
              f"wave max_abs_err {wav_err:.3g} (tol {wav_lim:.3g}); prosody classes "
              f"{sorted(set(inputs.prosody.flatten().tolist()))}", flush=True)
        check(mel_err <= mel_lim and wav_err <= wav_lim,
              "conditioned f32: kernels disagree with plain")

        # the timed requests
        expected = dict(EXPECTED_LAUNCHES)
        expected["fused_attention"] += PROSODY_LAUNCHES * len(sentences)
        reset_counts()
        runs = []
        for i in range(1 + COND_REQUESTS):
            before = read_counts()
            r = cond_request(torch, ti, vi, sentences, opts, timers, gen=gen)
            after = read_counts()
            per_request = {k: after[k] - before[k] for k in after}
            check(per_request == expected,
                  f"conditioned: launches per request {per_request} != {expected}")
            std = _check_wave("conditioned", r["wave"], r["lens"])
            r["audio_s"] = len(r["wave"]) / SR
            print(f"[conditioned] request {i}: {len(sentences)} sentences + LJ001-0002.wav -> "
                  f"{r['audio_s']:.2f} s audio (frames {r['lens']}), min std {std:.4f}; "
                  + ", ".join(f"{k} {v:.1f} ms" for k, v in r["ms"].items())
                  + f"; launches {per_request}", flush=True)
            runs.append(r)
        request_counts = read_counts()
        med = {k: float(np.median([r["ms"][k] for r in runs[1:]])) for k in runs[1]["ms"]}
        audio_s = float(np.median([r["audio_s"] for r in runs[1:]]))
        print(f"[conditioned] per request (f32, {gpu_line}): first {runs[0]['ms']['total']:.1f} "
              f"ms; median of the next {COND_REQUESTS}: "
              + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
              + f" ms; {audio_s:.2f} s of audio = {audio_s / (med['total'] / 1e3):.1f}x "
              f"realtime", flush=True)

        # resynthesize one SEGS utterance with the reference
        sega = sorted(SEGS.rglob("*.TextGridStage3"))[0]
        reset_counts()
        res_ms = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ti.resynthesize(sega, ref_audio=REF_WAV, generator=gen)
            mel, lens = _valid_mel(out)
            wave = vi.synthesize(mel).data
            res_ms.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                resynth_counts = read_counts()
        check(resynth_counts == EXPECTED_LAUNCHES,
              f"conditioned resynthesize: launches {resynth_counts} != {EXPECTED_LAUNCHES}")
        std = _check_wave("conditioned resynthesize", wave, lens)
        check(out.spectrogram.shape[2] % 64 == 0 and bool(torch.isfinite(out.spectrogram).all()),
              f"conditioned resynthesize: mel {tuple(out.spectrogram.shape)}")
        print(f"[conditioned] resynthesize {sega.relative_to(REPO)} with LJ001-0002.wav: t_out "
              f"{out.spectrogram.shape[2]} (the source mel), {lens[0]} frames -> "
              f"{len(wave) / SR:.2f} s audio, std {std:.4f}; {res_ms[0]:.1f} ms first, "
              f"{res_ms[1]:.1f} ms second (full pipeline on the host, model, vocoder); "
              f"launches {resynth_counts}", flush=True)
        prior_err = gmvae_prior_gate(torch, params, len(sentences), gpu_line)
    finally:
        E.set_biometric_model(None)
    del am, vm, ti, vi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[conditioned] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    launches = {k: request_counts[k] + resynth_counts[k] for k in request_counts}
    return {"launches": launches, "ms": med, "first_ms": runs[0]["ms"], "audio_s": audio_s,
            "resynthesize_ms": res_ms, "ecapa_err": ecapa_err, "ecapa_ms": ecapa_ms,
            "prior_err": prior_err, "phase_s": phase_s}


# -- phase 15: checkpoints of the JAX package ---------------------------------------

# tests/make_jax_checkpoints.py wrote these with the JAX package: the debug TTS recipe
# (transformer encoder and the wrapper decoder's, 64 wide, 4 heads of 16; variance
# predictors cut to 32 wide) and the debug BigVGAN vocoder (rates 8*8*2*2, 16 channels,
# one MRF branch), each after 2 steps on tests/data/SEGS, and the JAX interfaces' mel
# and waveform of one sentence under the model's own durations
JAX_FIXTURE = REPO / "tests" / "data" / "jax_checkpoints"
# the port on the card against the JAX package's recorded f32 output, as a share of the
# reference's largest magnitude: the whole acoustic model, then the vocoder (3xTF32
# attention, cuDNN convolutions without TF32, against XLA on the CPU)
TOL_JAX_MEL = 2e-5
TOL_JAX_WAV = 1e-4


def _tree_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


@contextlib.contextmanager
def injected_durations(torch, durations):
    """The duration predictor's output replaced by ``durations`` (frames a token),
    as the JAX reference was recorded under them."""
    from speechflow_torch.models.tts.predictors import TokenLevelDP

    saved = TokenLevelDP.__dict__["to_durations"]
    TokenLevelDP.to_durations = staticmethod(
        lambda log_d, lengths: torch.as_tensor(durations, device=log_d.device,
                                               dtype=torch.float32))
    try:
        yield
    finally:
        TokenLevelDP.to_durations = saved


def phase_jax_ckpt(torch, gpu_line: str) -> dict:
    """Checkpoints the JAX trainers wrote (orbax OCDBT, zstd zarr chunks) served on
    the card: read without JAX, into the TTS and vocoder interfaces and then into an
    ``InferenceBundle`` packed from them; the sentence's mel and waveform held against
    the JAX package's, the kernels against their plain versions."""
    import tempfile

    import numpy as np

    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts import export
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = np.load(JAX_FIXTURE / "reference.npz")
    sentence, speaker = str(ref["sentence"]), str(ref["speaker"])
    opts = TTSOptions(t_out=int(ref["t_out"]))
    loaded = {}
    for kind in ("tts", "vocoder"):
        ckpt = ExperimentSaver.get_last_checkpoint(JAX_FIXTURE / kind)
        check(ckpt is not None and (ckpt / "_METADATA").is_file(),
              f"jax_ckpt: no orbax checkpoint under {JAX_FIXTURE / kind}")
        t0 = time.perf_counter()
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        read_ms = 1e3 * (time.perf_counter() - t0)
        nbytes = _tree_bytes(ckpt)
        loaded[kind] = (ckpt, tree, payload)
        print(f"[jax_ckpt] {kind}: {ckpt.relative_to(REPO)}, {nbytes} bytes on disk, read in "
              f"{read_ms:.1f} ms ({nbytes / read_ms / 1e3:.2f} MB/s; host, first read; "
              f"{gpu_line})", flush=True)
    ckpt, tree, payload = loaded["tts"]
    ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt, device="cuda")
    _, tree, payload = loaded["vocoder"]
    vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")

    def request(tts, voc):
        out = tts.synthesize(sentence, lang="EN", speaker=speaker, opts=opts)
        mel = _valid_mel(out)[0]
        return out, mel.float().cpu().numpy(), voc.synthesize(mel).data

    with injected_durations(torch, ref["durations"]):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, mel, wav = request(ti, vi)
        torch.cuda.synchronize()
        req_ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        check(counts["fused_attention"] > 0 and counts["anti_alias_snake"] > 0,
              f"jax_ckpt: the request did not launch both kernels: {counts}")
        durs = out.attention.sum(1).float().cpu().numpy()
        check(np.array_equal(durs, ref["durations"]), "jax_ckpt: durations not injected")
        check(mel.shape == ref["mel"].shape and wav.shape == ref["wav"].shape,
              f"jax_ckpt: mel {mel.shape} / wave {wav.shape} against JAX's "
              f"{ref['mel'].shape} / {ref['wav'].shape}")
        mel_err = float(np.abs(mel - ref["mel"]).max())
        wav_err = float(np.abs(wav - ref["wav"]).max())
        mel_lim = TOL_JAX_MEL * float(np.abs(ref["mel"]).max())
        wav_lim = TOL_JAX_WAV * float(np.abs(ref["wav"]).max())
        print(f"[jax_ckpt] '{sentence}' by {speaker}: {mel.shape[0]} frames, "
              f"{wav.shape[0]} samples in {req_ms:.1f} ms (first request); launches {counts}; "
              f"against the JAX package's recorded output: mel max_abs_err {mel_err:.3g} "
              f"(tol {mel_lim:.3g}), waveform {wav_err:.3g} (tol {wav_lim:.3g})", flush=True)
        check(mel_err <= mel_lim and wav_err <= wav_lim,
              "jax_ckpt: the port disagrees with the JAX package's output")
        with plain_versions():
            _, mel_p, wav_p = request(ti, vi)
        errs = (float(np.abs(mel - mel_p).max()), float(np.abs(wav - wav_p).max()))
        lims = (TOL_F32_REL * float(np.abs(mel_p).max()),
                TOL_F32_REL * float(np.abs(wav_p).max()))
        print(f"[jax_ckpt] kernels vs plain: mel {errs[0]:.3g} (tol {lims[0]:.3g}), "
              f"waveform {errs[1]:.3g} (tol {lims[1]:.3g})", flush=True)
        check(errs[0] <= lims[0] and errs[1] <= lims[1],
              "jax_ckpt: the kernels disagree with the plain versions")
        with tempfile.TemporaryDirectory() as tmp:
            archive = export.pack(Path(tmp) / "jax.sftpu.tar.gz", tts=JAX_FIXTURE / "tts",
                                  vocoder=JAX_FIXTURE / "vocoder")
            bundle = export.InferenceBundle.load(archive, device="cuda")
            bundle.tts, bundle.vocoder
            before = read_counts()
            got = bundle.synthesize(sentence, lang="EN", speaker=speaker, opts=opts).data
            bundle_counts = {k: v - before[k] for k, v in read_counts().items()}
            b_err = float(np.abs(got - wav).max())
            print(f"[jax_ckpt] InferenceBundle packed from the JAX experiment directories "
                  f"({archive.stat().st_size} bytes): waveform against the interfaces' "
                  f"{b_err:.3g}; launches {bundle_counts}", flush=True)
            check(bundle_counts == counts and b_err <= TOL_F32_REL * float(np.abs(wav).max()),
                  "jax_ckpt: the bundle does not serve as the interfaces do")
            del bundle
    del ti, vi, loaded
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[jax_ckpt] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": {k: counts[k] + bundle_counts[k] for k in counts},
            "mel_err": mel_err, "wav_err": wav_err, "phase_s": phase_s}


# -- phase 16: the Vocos/ISTFT vocoder recipe's training -------------------------------

VOCODER_MODEL_CONFIG = "configs/vocoder_model.yml"
VOCODER_MODEL_STEPS = 3  # the cut: 3 of the recipe's 2,000,000 steps


def phase_vocoder_model_train(torch, gpu_line: str) -> dict:
    """``configs/vocoder_model.yml`` at its default width (mel features, Vocos 512 x
    8, ISTFT head, MPD + MRD at 32 channels, batch 32 of 1.0 s chunks) through
    ``train_vocoder`` on ``tests/data/SEGS``, then its checkpoint through the
    vocoder interface."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg, data_cfg = TV.configs("default", VOCODER_MODEL_CONFIG, data_root=SEGS)
    check(model_cfg["model"]["head"] == "istft" and model_cfg["model"]["dim"] == 512,
          f"vocoder_model_train: {VOCODER_MODEL_CONFIG} read as {model_cfg['model']}")
    model_cfg["trainer"].update(max_steps=VOCODER_MODEL_STEPS, ckpt_every=VOCODER_MODEL_STEPS,
                                log_every=1)
    st = {"ends": [], "losses": [], "trainer": None, "counts": []}

    def callback(trainer, last):
        torch.cuda.synchronize()
        st["ends"].append(time.perf_counter())
        st["trainer"] = trainer
        st["counts"].append(read_counts())
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()),
              f"vocoder_model_train: non-finite loss {vals}")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        expr = TV.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
        t_fit = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        ends = [t0] + st["ends"]
        step_ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
        ms = statistics.median(step_ms[1:])
        batch = int(model_cfg["batch"]["size"])
        chunk_s = float(data_cfg["preproc"]["pipe_cfg"]["random_chunk"]["chunk_duration"])
        rate = batch * chunk_s / (ms / 1e3)
        for i, (dt, vals) in enumerate(zip(step_ms, st["losses"])):
            print(f"[vocoder_model_train] step {i + 1}: {dt:.1f} ms, gen/total "
                  f"{vals['gen/total']:.4f}, disc/total {vals.get('disc/total', 0.0):.4f}",
                  flush=True)
        print(f"[vocoder_model_train] {VOCODER_MODEL_CONFIG} default (cut: "
              f"{VOCODER_MODEL_STEPS} steps): {t_fit:.1f} s with set-up; {ms:.1f} ms a step "
              f"(median of 2..{VOCODER_MODEL_STEPS}), {rate:.2f} s of audio trained per s "
              f"(batch {batch} x {chunk_s} s), peak device memory {peak / 2**30:.2f} GiB; "
              f"launches {launches} (the ISTFT head runs no hand kernel; {gpu_line})",
              flush=True)
        ckpt = ExperimentSaver.get_last_checkpoint(expr)
        check(ckpt is not None and ckpt.name == f"step_{VOCODER_MODEL_STEPS:09d}",
              f"vocoder_model_train: last checkpoint {ckpt}")
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")
        wav = _seg_waves(1, 64 * HOP * 4, offset=0)[0]
        out = vi.resynthesize(AudioChunk(data=wav, sr=SR)).data
        gen = st["trainer"].generator.eval()
        with torch.no_grad():
            ref = gen({"waveform": torch.from_numpy(wav)[None].to("cuda")})[0]
        ref = np.clip(ref.float().cpu().numpy(), -1.0, 1.0)
        err = float(np.abs(out - ref).max())
        lim = TOL_F32_REL * float(np.abs(ref).max())
        print(f"[vocoder_model_train] {ckpt.name} -> VocoderEvaluationInterface -> "
              f"resynthesize {len(wav) / SR:.2f} s: max_abs_err {err:.3g} against the trained "
              f"generator (tol {lim:.3g})", flush=True)
        check(out.shape == wav.shape and bool(np.isfinite(out).all()) and err <= lim,
              "vocoder_model_train: the reloaded checkpoint does not resynthesize as trained")
        del vi, tree, gen, st["trainer"]
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[vocoder_model_train] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": launches, "ms": ms, "audio_rate": rate, "peak": peak,
            "phase_s": phase_s}


# -- phase 17: the ForwardTacotron-class recipe's training -------------------------------

TTS_FORWARD_CONFIG = "configs/tts_forward.yml"
TTS_FORWARD_STEPS = 3  # the cut: 3 of the recipe's 300,000 steps
TTS_FORWARD_REQUEST = REQUEST_SENTENCES[:4]
TTS_FORWARD_FRAMES = 4  # frames a token injected into the served request
# the decoder's bi-GRU at the recipe's batch over a 1024-frame input, and the
# monotonic alignment search at the same batch over 128 tokens (the recipe runs no
# MAS; the in-model aligner of ``use_gradtts_fa`` would, at this shape)
GRU_TIMED = (48, 1024)
MAS_TIMED = (48, 128, 1024)


@contextlib.contextmanager
def planted_gru_fault(model):
    """The decoder's backward GRU run forward in time: the same weights, the other
    direction (a fault the gate must see)."""
    bwd = model.decoder.enc.bwd
    bwd.reverse = False
    try:
        yield
    finally:
        bwd.reverse = True


@contextlib.contextmanager
def injected_frames(torch, frames: int):
    """The duration predictor's output replaced by ``frames`` a valid token."""
    from speechflow_torch.models.tts.predictors import TokenLevelDP
    from speechflow_torch.utils.masks import sequence_mask

    saved = TokenLevelDP.__dict__["to_durations"]
    TokenLevelDP.to_durations = staticmethod(
        lambda log_d, lengths: sequence_mask(lengths, log_d.shape[1]).float() * frames)
    try:
        yield
    finally:
        TokenLevelDP.to_durations = saved


def tts_forward_gate(torch, model_cfg: dict, data_cfg: dict) -> dict:
    """One f32 step of ``configs/tts_forward.yml`` at its default width on the card
    and on the CPU: the same weights (flax's initialisers, seed 0), every dropout
    rate 0, the first two train utterances, the CPU's ReLU masks (``pinned_relus``);
    TF32 off. Losses within ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD``
    of its scale; the same gate must reject a planted fault (the decoder's backward
    GRU run forward)."""
    import copy

    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
    from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
    from speechflow_torch.scripts.common import model_config_from_info
    from speechflow_torch.utils.init import filter_kwargs

    t0 = time.perf_counter()
    pipeline = DataPipeline.from_config(data_cfg)
    params = ParallelTTSParams.create(model_config_from_info(model_cfg, pipeline))
    torch.manual_seed(0)
    cpu = ParallelTTSModel(params)
    no_dropout(cpu)
    card = copy.deepcopy(cpu).to("cuda")
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    inputs, targets = TTSBatchProcessor()(batch)
    crit = TTSCriterion(**filter_kwargs(TTSCriterion.__init__, dict(model_cfg["loss"])))
    pins = {}
    with pinned_relus(cpu, pins):
        ref = tts_step_grads(torch, cpu, crit, inputs, targets, None)
    zero = [k for k, v in ref[1].items() if not v.any()]
    check(not zero, f"tts_forward_train: reference gradients all zero: {zero}")
    args = (crit, _on(inputs, "cuda"), _on(targets, "cuda"), None)
    with pinned_relus(card, pins):
        got = tts_step_grads(torch, card, *args)
    flips = pins["flips"]
    with pinned_relus(card, pins), planted_gru_fault(card):
        bad = tts_step_grads(torch, card, *args)
    loss_err, grad_err, where = tts_disagreement(ref, got)
    f_loss, f_grad, f_where = tts_disagreement(ref, bad)
    print(f"[tts_forward_train] f32 step at default width, card vs CPU (flax's "
          f"initialisers, B2, mel {tuple(inputs.mel.shape)}, tokens "
          f"{tuple(inputs.transcription.shape)}, TF32 off, dropout 0; "
          f"{time.perf_counter() - t0:.1f} s): losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f"; worst loss error {loss_err:.3g} of the loss (tol {TOL_F32_REL:g}); "
          f"{len(ref[1])} gradients, worst {grad_err:.3g} of scale ({where}; tol "
          f"{TOL_TTS_GRAD:g}); ReLU pre-activations pinned to the CPU's side: {flips}",
          flush=True)
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"tts_forward_train f32: the card disagrees with the CPU: loss {loss_err}, "
          f"{where} {grad_err}")
    print(f"[tts_forward_train] planted fault (the decoder's backward GRU run forward): "
          f"worst loss error {f_loss:.3g}, worst gradient {f_grad:.3g} of scale ({f_where})",
          flush=True)
    check(max(f_loss / TOL_F32_REL, f_grad / TOL_TTS_GRAD) > 1,
          "the tts_forward_train gate passes a planted fault (backward GRU run forward)")
    del cpu, card, got, ref, bad
    torch.cuda.empty_cache()
    return {"grad_err": grad_err, "loss_err": loss_err, "fault_grad_err": f_grad}


def time_recurrences(torch, model, gpu_line: str) -> dict:
    """The trained model's decoder bi-GRU (forward and backward) at ``GRU_TIMED`` and
    ``maximum_path`` at ``MAS_TIMED``, on the card, CUDA events."""
    from speechflow_torch.ops.mas import maximum_path

    b, t = GRU_TIMED
    enc = model.decoder.enc
    x = torch.randn(b, t, enc.fwd.cell.dense_i.in_features, device="cuda", requires_grad=True)

    def gru():
        enc(x).square().mean().backward()

    gru_ms = cuda_ms(gru, 5)
    with torch.no_grad():
        gru_fwd_ms = cuda_ms(lambda: enc(x), 5)
    bm, n, tm = MAS_TIMED
    value = torch.randn(bm, n, tm, device="cuda")
    tl = torch.full((bm,), n, device="cuda")
    ml = torch.full((bm,), tm, device="cuda")
    mas_ms = cuda_ms(lambda: maximum_path(value, tl, ml), 3)
    print(f"[tts_forward_train] decoder bi-GRU ({enc.fwd.hidden} + {enc.bwd.hidden} wide, "
          f"cuDNN, f32) over B{b} x {t} frames: forward {gru_fwd_ms:.2f} ms, forward and "
          f"backward {gru_ms:.2f} ms; maximum_path B{bm} x {n} tokens x {tm} frames "
          f"(the scan on the card, the backtrace on the host): {mas_ms:.2f} ms ({gpu_line})",
          flush=True)
    return {"gru_ms": gru_ms, "gru_fwd_ms": gru_fwd_ms, "mas_ms": mas_ms}


def phase_tts_forward_train(torch, gpu_line: str) -> dict:
    """``configs/tts_forward.yml`` trained through ``train_tts`` at its default width,
    then its checkpoint served through the TTS and vocoder interfaces on BigVGAN."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg, data_cfg = TT.configs("default", TTS_FORWARD_CONFIG, data_root=SEGS)
    m = model_cfg["model"]
    check(m["encoder_type"] == "rnn" and m["decoder_inner"] == "rnn"
          and m["encoder_dim"] == 256, f"tts_forward_train: {TTS_FORWARD_CONFIG} read as {m}")
    res = {"gate": tts_forward_gate(torch, model_cfg, data_cfg)}
    model_cfg["trainer"].update(max_steps=TTS_FORWARD_STEPS, ckpt_every=TTS_FORWARD_STEPS,
                                log_every=1)
    mixed = bool(model_cfg["trainer"].get("mixed_precision", False))
    st = {"ref": None, "steps": [], "losses": [], "trainer": None}
    real_step = Trainer.training_step

    def step(self, batch):
        if st["ref"] is None:
            st["ref"] = [p.detach().clone() for p in self.model.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        st["steps"].append((1e3 * (time.perf_counter() - t0), int(batch.mel_lengths.sum()),
                            tuple(batch.mel.shape)))
        return out

    def callback(trainer, last):
        st["trainer"] = trainer
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()),
              f"tts_forward_train: non-finite loss {vals}")
        changed = any(not torch.equal(p, r)
                      for p, r in zip(trainer.model.parameters(), st["ref"]))
        check(changed == (trainer.global_step >= 2),
              f"tts_forward_train: weights {'changed' if changed else 'unchanged'} after "
              f"step {trainer.global_step} (lr 0 at count 0, then the warmup's)")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        Trainer.training_step = step
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            expr = TT.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
            t_fit = time.perf_counter() - t0
        finally:
            Trainer.training_step = real_step
        peak = torch.cuda.max_memory_allocated()
        train_counts = read_counts()
        for i, ((ms_i, n, mel), vals) in enumerate(zip(st["steps"], st["losses"])):
            print(f"[tts_forward_train] step {i + 1}: {ms_i:.1f} ms, mel {mel}, {n} valid "
                  f"frames; losses " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()),
                  flush=True)
        step_ms = [s[0] for s in st["steps"]]
        ms = statistics.median(step_ms[1:])
        rate = sum(s[1] for s in st["steps"][1:]) / (sum(step_ms[1:]) / 1e3)
        print(f"[tts_forward_train] {TTS_FORWARD_CONFIG} default (cut: {TTS_FORWARD_STEPS} "
              f"steps; mixed_precision {mixed}): {t_fit:.1f} s with set-up; {ms:.1f} ms a "
              f"step (median of 2..{TTS_FORWARD_STEPS}), {rate:.0f} mel frames trained per "
              f"second, peak device memory {peak / 2**30:.2f} GiB; launches {train_counts} "
              f"({gpu_line})", flush=True)
        res.update(time_recurrences(torch, st["trainer"].model, gpu_line))

        ckpt = ExperimentSaver.get_last_checkpoint(expr)
        check(ckpt is not None and ckpt.name == f"step_{TTS_FORWARD_STEPS:09d}",
              f"tts_forward_train: last checkpoint {ckpt}")
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt,
                                                    device="cuda")
        speaker = ti.get_speakers()[0]
        ctx = ti.prepare_embeddings(ti.create_context("EN", speaker))
        opts = TTSOptions(t_out=T_FRAMES)
        _, voc_params = serving.flagship_params()
        vm = seeded_vocoder(torch, voc_params)
        vi = VocoderEvaluationInterface(vm.to("cuda"))
        sentences = list(TTS_FORWARD_REQUEST)
        with injected_frames(torch, TTS_FORWARD_FRAMES):
            reset_counts()
            got = tts_request(torch, ti, vi, sentences, ctx, opts)
            request_counts = read_counts()
            with plain_versions():
                ref = tts_request(torch, ti, vi, sentences, ctx, opts)
        check(torch.equal(got["out"].attention.sum(1), ref["out"].attention.sum(1)),
              "tts_forward_train: durations differ between two calls")
        wave, lens = got["wave"], got["lens"]
        wav_err = float(np.abs(wave - ref["wave"]).max())
        wav_lim = TOL_F32_REL * float(np.abs(ref["wave"]).max())
        ms_r = got["ms"]
        print(f"[tts_forward_train] {ckpt.name} -> TTSEvaluationInterface -> BigVGAN "
              f"(flagship width, seeded), f32, {TTS_FORWARD_FRAMES} frames a token injected "
              f"(6 steps predict none): {len(sentences)} sentences, frames {lens} -> "
              f"{len(wave) / SR:.3f} s audio; frontend {ms_r['frontend']:.1f} ms, acoustic "
              f"{ms_r['acoustic']:.1f} ms, vocoder {ms_r['vocoder']:.1f} ms (first call); "
              f"launches {request_counts}; kernels vs plain: wave max_abs_err {wav_err:.3g} "
              f"(tol {wav_lim:.3g})", flush=True)
        check(wave.shape == ((sum(lens) - 1) * HOP,) and bool(np.isfinite(wave).all())
              and wav_err <= wav_lim, "tts_forward_train: the checkpoint does not serve")
        check(request_counts["fused_attention"] == 0
              and all(request_counts[k] == v for k, v in HEAD_LAUNCHES.items()),
              f"tts_forward_train: the request's launches {request_counts}")
        del ti, vi, vm, got, ref, st["trainer"], tree
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[tts_forward_train] phase wall time {phase_s:.1f} s", flush=True)
    res.update(launches={k: train_counts[k] + request_counts[k] for k in train_counts},
               ms=ms, frame_rate=rate, peak=peak, phase_s=phase_s)
    return res


# -- phase 18: JAX training runs resumed on the card ------------------------------------

RESUME_RECORD = JAX_FIXTURE / "resume_record.npz"
# the port's resumed step against JAX's recorded one: each Adam moment within this
# share of the model's largest (the step's new gradient enters mu at 0.1: a leaky ReLU
# or hinge element on the other side of 0, a kink, moves a 2-channel discriminator
# bias's gradient by a few percent); a moment restarted from zero would be off by 0.9
# of the saved one. The parameters within two Adam steps (lr each) of JAX's: near a
# kink or at a gradient near 0 the two sides may step apart
TOL_RESUME_MOMENT = 1e-3


def _flax_state(module, opt, key: str) -> dict:
    """The optimizer state ``key`` of every parameter of ``module`` in flax's layout
    (dotted paths, as ``convert.flatten_nnx``)."""
    import copy

    import torch

    from speechflow_torch.convert import flatten_nnx, nnx_from_module

    view = copy.deepcopy(module)
    state = {n: opt.base.state[p][key] for n, p in zip(opt.names, opt.params)}
    with torch.no_grad():
        for name, p in view.named_parameters():
            p.copy_(state[name])
    return flatten_nnx(nnx_from_module(view))


def _held(rec, prefix: str, module, opt, lr: float) -> dict:
    """The port's parameters and moments at the record's sampled elements against
    JAX's: the worst error of each against its limit."""
    import numpy as np

    from speechflow_torch.convert import flatten_nnx, nnx_from_module

    trees = {"param": flatten_nnx(nnx_from_module(module)),
             "mu": _flax_state(module, opt, "exp_avg"),
             "nu": _flax_state(module, opt, "exp_avg_sq")}
    keys = [k[len(f"{prefix}/idx/"):] for k in rec.files if k.startswith(f"{prefix}/idx/")]
    check(keys and set(keys) == set(trees["param"]),
          f"jax_resume: {prefix}: the record's leaves are not the model's")
    worst = {}
    for name, tree in trees.items():
        ref = {k: rec[f"{prefix}/{name}/{k}"] for k in keys}
        scale = max(float(np.abs(v).max()) for v in ref.values())
        errs = []
        for k in keys:
            got = tree[k].reshape(-1)[rec[f"{prefix}/idx/{k}"]]
            lim = 2 * lr if name == "param" else TOL_RESUME_MOMENT * scale
            errs.append((float(np.abs(got - ref[k]).max()) / max(lim, 1e-30), k))
        worst[name] = max(errs)
    return worst


def resumed_tts_trainer(torch, cfg: dict, run: Path, device: str):
    """A ``Trainer`` of the acoustic model of the JAX run in ``run`` (its model config
    ``cfg``) on ``device``, resumed as ``-r`` resumes it (``apply_resume_warmstart``),
    every dropout rate 0."""
    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion
    from speechflow_torch.scripts.common import (
        apply_resume_warmstart,
        optimizer_config,
        trainer_config,
    )
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer
    from speechflow_torch.utils.init import filter_kwargs

    ckpt = ExperimentSaver.get_last_checkpoint(run)
    check(ckpt is not None and (ckpt / "_METADATA").is_file(), f"no JAX run in {run}")
    _, payload = ExperimentSaver.load_checkpoint(ckpt)
    torch.manual_seed(0)
    model = ParallelTTSModel(ParallelTTSParams.create(payload["model_params"])).to(device)
    crit = TTSCriterion(**filter_kwargs(TTSCriterion.__init__, dict(cfg["loss"])))
    trainer = Trainer(model, crit, lambda batch: batch, optimizer_config(cfg),
                      trainer_config(cfg))
    apply_resume_warmstart(trainer, {"resume": {"from": str(run)}})
    no_dropout(model)
    return trainer


def recorded_tts_batch(torch, rec) -> tuple:
    """The acoustic model's recorded batch (``tts/in/*``, ``tts/tgt/*``) of a resume record."""
    from speechflow_torch.models.tts import TTSForwardInput, TTSTarget

    def fields(cls, tag):
        return cls(**{f: torch.from_numpy(rec[f"tts/{tag}/{f}"])
                      for f in cls.__dataclass_fields__ if f"tts/{tag}/{f}" in rec.files})

    return fields(TTSForwardInput, "in"), fields(TTSTarget, "tgt")


def jax_resume_step(torch, kind: str, device: str) -> dict:
    """The JAX run of ``tests/data/jax_checkpoints/resume/<kind>`` resumed on ``device``
    as ``-r`` resumes it (``apply_resume_warmstart`` for the acoustic model, the GAN
    trainer's ``load_checkpoint`` as ``train_vocoder`` calls it), every dropout rate 0,
    one step on the recorded batch: losses, sampled parameters and Adam moments
    against JAX's next step."""
    import numpy as np

    from speechflow_torch.io.config import value_select, yaml_load
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.batch_processor import VocoderBatchProcessor
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.scripts.common import optimizer_config, trainer_config
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.utils.init import filter_kwargs

    rec = np.load(RESUME_RECORD)
    cfg = value_select(yaml_load(str(rec[f"{kind}/config_yaml"])), ["debug"])
    run = JAX_FIXTURE / "resume" / kind
    ckpt = ExperimentSaver.get_last_checkpoint(run)
    check(ckpt is not None and (ckpt / "_METADATA").is_file(), f"jax_resume: no run in {run}")
    _, payload = ExperimentSaver.load_checkpoint(ckpt)
    torch.manual_seed(0)
    t0 = time.perf_counter()
    if kind == "tts":
        trainer = resumed_tts_trainer(torch, cfg, run, device)
        model = trainer.model
        step0, count0 = trainer.global_step, trainer.optimizer.count
        losses = trainer.training_step(recorded_tts_batch(torch, rec))
        opts = (("tts", model, trainer.optimizer),)
        counts = (trainer.global_step, trainer.optimizer.count)
    else:
        params = VocosParams.create(payload["model_params"])
        gen = Vocos(params).to(device)
        disc = VocoderDiscriminator(**filter_kwargs(VocoderDiscriminator.__init__,
                                                    cfg["discriminator"])).to(device)
        loss_cfg = dict(cfg["loss"])
        gan_cfg = cfg.get("gan") or {}
        trainer = GANTrainer(
            gen, disc, vocoder_gen_criterion(sample_rate=params.sample_rate,
                                             n_mels=params.n_mels,
                                             **filter_kwargs(vocoder_gen_criterion, loss_cfg)),
            vocoder_disc_criterion(), VocoderBatchProcessor(device=torch.device(device)),
            gen_optimizer=optimizer_config(cfg), disc_optimizer=optimizer_config(cfg),
            config=trainer_config(cfg), disc_every=int(gan_cfg.get("disc_every", 1)),
            disc_start_iter=int(gan_cfg.get("disc_start_iter", 0)))
        trainer.load_checkpoint(ckpt)
        step0, count0 = trainer.global_step, trainer.gen_opt.count
        losses = trainer.training_step({"waveform": rec["vocoder/waveform"]})
        opts = (("vocoder/gen", gen, trainer.gen_opt), ("vocoder/disc", disc, trainer.disc_opt))
        counts = (trainer.global_step, trainer.gen_opt.count, trainer.disc_opt.count)
    if device == "cuda":
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    loss_err = max(abs(float(losses[k]) - float(rec[f"{kind}/loss/{k}"]))
                   / max(abs(float(rec[f"{kind}/loss/{k}"])), 1e-6)
                   for k in losses if f"{kind}/loss/{k}" in rec.files)
    check(all(f"{kind}/loss/{k}" in rec.files for k in losses),
          f"jax_resume: {kind}: losses {sorted(losses)} not all in the record")
    lr = trainer.optimizer.schedule(count0) if kind == "tts" else \
        trainer.gen_opt.schedule(count0)
    held = {prefix: _held(rec, prefix, module, opt, lr) for prefix, module, opt in opts}
    print(f"[jax_resume] {kind}: {ckpt.relative_to(REPO)} resumed at step {step0} (applied "
          f"steps {count0}) on {device}, one step on the recorded batch ({step_ms:.1f} ms with "
          f"the resume); steps after {counts}; losses against JAX's next step: worst "
          f"{loss_err:.3g} of the loss (tol {TOL_F32_REL:g}); worst share of the limit: "
          + "; ".join(f"{p}: " + ", ".join(f"{n} {v[0]:.3g} ({v[1]})" for n, v in h.items())
                      for p, h in held.items()), flush=True)
    check(loss_err <= TOL_F32_REL, f"jax_resume: {kind}: losses disagree with JAX's")
    check(all(v[0] <= 1 for h in held.values() for v in h.values()),
          f"jax_resume: {kind}: the resumed step disagrees with JAX's")
    return {"loss_err": loss_err, "held": held, "step0": step0, "count0": count0,
            "ms": step_ms}


def phase_jax_resume(torch, gpu_line: str) -> dict:
    """The JAX runs of ``tests/data/jax_checkpoints/resume`` resumed with their
    optimizer state on the card, each for one step against JAX's recorded next one
    (cuDNN deterministic: its transform algorithms can turn a conv of silence into
    ±1e-12 where XLA gives 0, the leaky ReLU's kink)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        res = {kind: jax_resume_step(torch, kind, "cuda") for kind in ("tts", "vocoder")}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[jax_resume] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    return {"launches": read_counts(), "phase_s": phase_s, **res}


# -- phase 19: the acoustic-model options on the card ------------------------------------

# one model at the kit's default width (256) that turns on what the JAX package builds
# beyond the recipes' paths: a multi-stream context encoder (a conformer and a
# transformer sub-encoder, each attending through the fused kernel at inference), the
# variance options (embeddings, per-stream routing, an LSGAN discriminator, the in-model
# aligner with its monotonic alignment search), per-utterance averages, the inverse
# speaker classifier and the Tacotron decoder
TTS_OPTIONS = dict(
    n_symbols=100, n_speakers=4, n_mels=100, encoder_type="context",
    encoder_sub_types=("conformer", "transformer"), encoder_concat_streams=False,
    condition_levels=(0, 1, 2), use_average_emb=True,
    averages={"rate": {"interval": [0.0, 10.0], "n_bins": 16, "emb_dim": 16}},
    use_inverse_speaker_classifier=True, decoder_type="taco",
    variances=({"name": "aggregate_pitch", "as_embedding": True, "cat_to_streams": (0, 1),
                "use_discriminator": True},
               {"name": "aggregate_energy", "input_stream": 1, "as_embedding": True,
                "interval": (0.0, 150.0)},
               {"name": "durations", "input_stream": 1, "use_gradtts_fa": True,
                "fa_feat_dim": 100}))
OPTIONS_SHAPE = (4, 64, 256)  # B, tokens, mel frames of the training batch
OPTIONS_T_OUT = 128           # frames of the inference call (the Tacotron decoder's budget)
# attention launches of one inference call: 4 conformer and 4 transformer blocks
OPTIONS_LAUNCHES = {"fused_attention": 8, "anti_alias_snake": 0, "aa_upsample_fir": 0,
                    "aa_snake_downsample": 0}


def options_batch(torch, rng, device):
    """(inputs, targets) of a random teacher-forced batch at ``OPTIONS_SHAPE``."""
    import numpy as np

    from speechflow_torch.models.tts import TTSForwardInput, TTSTarget

    b, n, t = OPTIONS_SHAPE
    lens = np.array([n, n - 9, n - 20, n - 33])
    mel_lens = np.array([t, t - 31, t - 70, t - 101])
    valid = np.arange(n)[None] < lens[:, None]
    frames = np.arange(t)[None] < mel_lens[:, None]

    def f(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    inputs = TTSForwardInput(
        transcription=f(np.where(valid, rng.integers(1, 100, (b, n)), 0)),
        transcription_lengths=f(lens), speaker_id=f(rng.integers(0, 4, b)),
        lang_id=f(np.zeros(b, np.int64)),
        aggregate_pitch=f((rng.uniform(80, 300, (b, n)) * valid).astype(np.float32)),
        aggregate_energy=f((rng.uniform(0, 100, (b, n)) * valid).astype(np.float32)),
        mel=f((rng.normal(size=(b, t, 100)) * frames[..., None]).astype(np.float32)),
        mel_lengths=f(mel_lens), averages={"rate": f(rng.uniform(0, 10, b).astype(np.float32))})
    targets = TTSTarget(mel=inputs.mel, mel_lengths=inputs.mel_lengths,
                        gate=f((np.arange(t)[None] >= mel_lens[:, None] - 1).astype(np.float32)),
                        aggregate_pitch=inputs.aggregate_pitch,
                        aggregate_energy=inputs.aggregate_energy,
                        transcription_lengths=inputs.transcription_lengths,
                        speaker_id=inputs.speaker_id)
    return inputs, targets


def phase_tts_options(torch, gpu_line: str) -> dict:
    """``TTS_OPTIONS`` on the card (f32, flax's initialisers): a training step (every
    loss finite, every gradient finite, no fused-attention launch: training drops
    attention weights), then an inference call through the kernels and through the
    plain versions (8 attention launches; durations equal, mel within
    ``TOL_F32_REL``)."""
    import dataclasses

    import numpy as np

    from speechflow_torch.models.tts import ParallelTTSModel, ParallelTTSParams, TTSCriterion

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = ParallelTTSModel(ParallelTTSParams.create(TTS_OPTIONS)).to("cuda")
    inputs, targets = options_batch(torch, np.random.default_rng(0), "cuda")
    crit = TTSCriterion(inverse_speaker_scale=0.1)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = crit(model.train()(inputs, training=True), targets, 0)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    train_ms = 1e3 * (time.perf_counter() - t0)
    train_counts = read_counts()
    bad = [n for n, p in model.named_parameters()
           if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    check(all(np.isfinite(float(v.detach())) for v in losses.values()) and not bad,
          f"tts_options: non-finite losses {losses} or gradients {bad}")
    expected = {"fa_duration", "fa_prior", "aggregate_pitch_disc_loss",
                "aggregate_pitch_gen_loss", "inverse_speaker", "spectral", "gate"}
    check(expected <= set(losses), f"tts_options: losses {sorted(losses)}")
    check(train_counts["fused_attention"] == 0,
          f"tts_options: the training call launched attention: {train_counts}")
    model.zero_grad(set_to_none=True)
    raw = dataclasses.replace(inputs, mel=None, mel_lengths=None, aggregate_pitch=None,
                              aggregate_energy=None, averages=None)
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.eval()(raw, t_out=OPTIONS_T_OUT)
        torch.cuda.synchronize()
        infer_ms = 1e3 * (time.perf_counter() - t0)
        counts = read_counts()
        with plain_versions():
            ref = model(raw, t_out=OPTIONS_T_OUT)
    check(counts == OPTIONS_LAUNCHES, f"tts_options: inference launches {counts}")
    check(torch.equal(out.spectrogram_lengths, ref.spectrogram_lengths),
          "tts_options: lengths differ, kernels vs plain")
    err, lim = (out.spectrogram - ref.spectrogram).abs().max().item(), rel_limit(ref.spectrogram)
    print(f"[tts_options] {TTS_OPTIONS['encoder_type']} encoder "
          f"{TTS_OPTIONS['encoder_sub_types']} in streams, as_embedding, routing, a pitch "
          f"discriminator, the in-model aligner, averages, the inverse speaker classifier, "
          f"the Tacotron decoder; default width, f32: a training step B{OPTIONS_SHAPE[0]} x "
          f"{OPTIONS_SHAPE[1]} tokens x {OPTIONS_SHAPE[2]} frames {train_ms:.1f} ms (first "
          f"call), losses " + ", ".join(f"{k} {float(v.detach()):.4g}" for k, v in losses.items())
          + f"; inference {OPTIONS_T_OUT} frames {infer_ms:.1f} ms (first call), frames "
          f"{out.spectrogram_lengths.tolist()}, launches {counts}; kernels vs plain: mel "
          f"max_abs_err {err:.3g} (tol {lim:.3g}) ({gpu_line})", flush=True)
    check(err <= lim, "tts_options: the kernels disagree with the plain versions")
    del model, out, ref
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[tts_options] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": {k: train_counts[k] + counts[k] for k in counts},
            "train_ms": train_ms, "infer_ms": infer_ms, "err": err, "phase_s": phase_s}


# -- phase 20: E2E GAN-TTS (styletts2_e2e and its ft) ----------------------------------

E2E_CONFIG = "configs/vocoder_styletts2_e2e.yml"
E2E_FT_CONFIG = "configs/vocoder_styletts2_e2e_ft.yml"
E2E_DATA_CONFIG = "configs/tts_data_24khz.yml"
E2E_STEPS = 2      # the cut: 2 of the recipe's 1,000,000 steps
E2E_FT_STEPS = 2   # and 2 of the ft recipe's 200,000
E2E_SERVE_ROWS = 4  # sentences of the served text batch
E2E_FRAMES = 4      # frames a token injected into it


def trivial_disc(x):
    """A discriminator stand-in for the generator gates, whose adversarial and
    feature-matching weights are 0 (the kinks of the real discriminators are the
    ``train`` phase's gate, ``pinned_kinks``)."""
    return [x.mean(-1, keepdim=True)], [[x]]


def gen_step_grads(torch, model, crit, inputs, targets, draws) -> tuple:
    """One generator call without the optimizer: ({loss: value}, {parameter: gradient
    on the CPU}, the waveform). The gradients are those of a fixed cotangent on the waveform (a seeded
    normal, drawn on the CPU) plus the extractor's own losses: the STFT losses' log|X|
    of tiny bins would amplify the card's rounding (ROADMAP §3, expected difference 4),
    as in the ``train`` phase's gate."""
    from speechflow_torch.models.vocoder.model import split_output

    for p in model.parameters():
        p.grad = None
    out = model(inputs, sine_noise=draws)
    losses = crit(out, trivial_disc, inputs, targets, 0)
    wav, ft = split_output(out)
    cot = torch.randn(wav.shape, generator=torch.Generator().manual_seed(7)).to(wav.device)
    ((wav * cot).sum() + sum(ft.values())).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()},
            wav.detach())


@contextlib.contextmanager
def planted_flip_fault(conv):
    """A transposed conv run with its kernel flipped, as ``nn.ConvTranspose1d`` with
    the flax kernel would run it (a fault the gates must see)."""
    import torch.nn.functional as F

    real = conv.forward

    def flipped(x):
        b, t, c = x.shape
        xd = x.new_zeros(b, c, (t - 1) * conv.stride + 1)
        xd[:, :, ::conv.stride] = x.transpose(1, 2)
        return F.conv1d(F.pad(xd, conv.pads), conv.weight.flip(-1), conv.bias).transpose(1, 2)

    conv.forward = flipped
    try:
        yield
    finally:
        conv.forward = real


@contextlib.contextmanager
def pinned_leaky_relus(pins: dict):
    """The NSF head's leaky ReLUs (``nsf.leaky_relu``) with each element's side of 0
    recorded in call order (``pins["masks"]`` None), else replayed, counting in
    ``pins["flips"]`` the pre-activations that took the other side here: the same
    values and gradients where the sides agree."""
    import torch

    from speechflow_torch.models.vocoder import nsf

    record = pins.get("masks") is None
    if record:
        pins["masks"] = []
    pins["flips"], calls = 0, iter(range(len(pins["masks"])))
    real = nsf.leaky_relu

    def pinned(x, negative_slope=0.1):
        if record:
            mask = x >= 0
            pins["masks"].append(mask.cpu())
        else:
            mask = pins["masks"][next(calls)].to(x.device)
            pins["flips"] += int((mask != (x >= 0)).sum())
        return torch.where(mask, x, x * negative_slope)

    nsf.leaky_relu = pinned
    try:
        yield
    finally:
        nsf.leaky_relu = real


def generator_gate(torch, label: str, cpu, inputs, targets, frames: int, fault) -> dict:
    """One f32 generator step on the card and on the CPU from the same weights,
    batch and sine-source draws (every dropout rate 0, the acoustic model's ReLUs and
    the NSF head's leaky ReLUs pinned to the CPU's side, TF32 off), the adversarial
    and feature-matching terms off: losses within ``TOL_F32_REL``; the gradients of a
    fixed waveform cotangent plus the extractor's losses (``gen_step_grads``) within
    ``TOL_TTS_GRAD`` of each tensor's scale; the same gate must reject ``fault(card)``, a
    planted fault."""
    import copy

    from speechflow_torch.models.vocoder.criterion import vocoder_gen_criterion
    from speechflow_torch.training.trainer import _place

    t0 = time.perf_counter()
    p = cpu.params
    crit = vocoder_gen_criterion(p.sample_rate, p.n_mels, adv_weight=0.0, fm_weight=0.0)
    no_dropout(cpu)
    card = copy.deepcopy(cpu).to("cuda")
    draws = None
    if cpu.nsf_head:
        hop = p.hop_length
        draws = cpu.head.sine_gen.draw(inputs["waveform"].shape[0], frames * hop, "cpu",
                                       torch.Generator().manual_seed(0))
    pins, leaky = {}, {}
    with pinned_relus(cpu, pins), pinned_leaky_relus(leaky):
        ref = gen_step_grads(torch, cpu, crit, inputs, targets, draws)
    args = (crit, _place(inputs, torch.device("cuda")), _place(targets, torch.device("cuda")),
            None if draws is None else tuple(d.cuda() for d in draws))
    with pinned_relus(card, pins), pinned_leaky_relus(leaky):
        got = gen_step_grads(torch, card, *args)
    flips = (pins["flips"], leaky["flips"])
    with pinned_relus(card, pins), pinned_leaky_relus(leaky), fault(card):
        bad = gen_step_grads(torch, card, *args)
    loss_err, grad_err, where = tts_disagreement(ref, got)
    f_loss, f_grad, f_where = tts_disagreement(ref, bad)
    print(f"[{label}] f32 generator step at default width, card vs CPU (flax's initialisers, "
          f"B{inputs['waveform'].shape[0]}, {frames} frames, TF32 off, dropout 0, the same "
          f"sine draws; {time.perf_counter() - t0:.1f} s): losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f"; worst loss error {loss_err:.3g} of the loss (tol {TOL_F32_REL:g}); "
          f"{len(ref[1])} gradients (a waveform cotangent and the extractor's losses), worst "
          f"{grad_err:.3g} of scale ({where}; tol {TOL_TTS_GRAD:g}); pre-activations on the "
          f"other side of 0 on the card, pinned to "
          f"the CPU's: {flips[0]} of the acoustic model's ReLUs, {flips[1]} of the NSF head's "
          f"leaky ReLUs (of {sum(m.numel() for m in leaky.get('masks', []))}); planted fault "
          f"(the first transposed conv's kernel flipped): loss {f_loss:.3g}, gradient "
          f"{f_grad:.3g} ({f_where})", flush=True)
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"{label} f32: the card disagrees with the CPU: loss {loss_err}, {where} {grad_err}")
    check(max(f_loss / TOL_F32_REL, f_grad / TOL_TTS_GRAD) > 1,
          f"the {label} gate passes a planted fault (a transposed conv's kernel flipped)")
    del card
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_err": grad_err, "fault_grad_err": f_grad}


def flip_first_up(model):
    return planted_flip_fault(model.head.ups[0])


def timed_fit(torch, label: str, trainer_cls, train_fn, model_cfg: dict, data_cfg: dict,
              steps: int, tmp: str, work_of_batch) -> dict:
    """``train_fn`` (a script's ``train``) for ``steps`` steps into ``tmp``, each
    ``trainer_cls.training_step`` timed between synchronisations: finite losses; ms a
    step (median of 2..), work a second (``work_of_batch(batch)`` gives each step's
    amount of work and its note), peak memory, launches, the experiment directory and
    the trainer."""
    import copy
    import statistics

    import numpy as np

    from speechflow_torch.scripts.common import experiment_saver

    model_cfg = copy.deepcopy(model_cfg)
    model_cfg["trainer"].update(max_steps=steps, ckpt_every=steps, log_every=1)
    st = {"steps": [], "losses": [], "trainer": None}
    real_step = trainer_cls.training_step

    def step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        st["steps"].append((1e3 * (time.perf_counter() - t0), *work_of_batch(batch)))
        return out

    def callback(trainer, last):
        st["trainer"] = trainer
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()), f"{label}: non-finite loss {vals}")

    saver = experiment_saver(model_cfg, data_cfg, tmp)
    trainer_cls.training_step = step
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        expr = train_fn(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
        t_fit = time.perf_counter() - t0
    finally:
        trainer_cls.training_step = real_step
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, ((ms_i, _, note), vals) in enumerate(zip(st["steps"], st["losses"])):
        print(f"[{label}] step {i + 1}: {ms_i:.1f} ms, {note}; "
              + ", ".join(f"{k} {v:.4g}" for k, v in vals.items() if not k.startswith("val/")),
              flush=True)
    timed = st["steps"][1:] or st["steps"]
    return {"expr": expr, "ms": statistics.median(s[0] for s in timed),
            "rate": sum(s[1] for s in timed) / (sum(s[0] for s in timed) / 1e3),
            "peak": peak, "launches": launches, "trainer": st["trainer"], "t_fit": t_fit}


def gan_run(torch, label: str, train_fn, model_cfg: dict, data_cfg: dict, steps: int,
            tmp: str, audio_s) -> dict:
    """``timed_fit`` of ``train_fn`` (``train_vocoder.train``) for ``steps`` micro-batches,
    ``audio_s(batch)`` seconds of audio each."""
    from speechflow_torch.training.gan_trainer import GANTrainer

    def work(batch):
        secs = audio_s(batch)
        return secs, f"{secs:.2f} s of audio"

    run = timed_fit(torch, label, GANTrainer, train_fn, model_cfg, data_cfg, steps, tmp, work)
    print(f"[{label}] {steps} steps: {run['t_fit']:.1f} s with set-up; {run['ms']:.1f} ms a "
          f"step (median of 2..{steps}), {run['rate']:.2f} s of audio trained per s, peak "
          f"device memory {run['peak'] / 2**30:.2f} GiB; launches {run['launches']}", flush=True)
    return dict(run, audio_rate=run["rate"])


@contextlib.contextmanager
def counted_vjps():
    """Counts of the fused anti-alias entry's VJP calls (``counts["vjp"]``)."""
    from speechflow_torch.ops import anti_alias as AA

    counts = {"vjp": 0}
    real = AA.anti_alias_snake_vjp

    def counting(*args, **kwargs):
        counts["vjp"] += 1
        return real(*args, **kwargs)

    AA.anti_alias_snake_vjp = counting
    try:
        yield counts
    finally:
        AA.anti_alias_snake_vjp = real


def ft_kernel_gate(torch, model, inputs, targets) -> dict:
    """The ``_ft`` recipe's trained generator (the BigVGAN head's anti-aliased snakes under
    autograd) on one batch, f32 with TF32 off and every dropout rate 0, through the kernels
    and through the plain versions from the same weights, the acoustic model's ReLUs pinned
    to the plain run's side: the waveform within ``TOL_F32_REL`` of its scale, the losses
    within ``TOL_F32_REL``, the gradients of a fixed waveform cotangent plus the extractor's
    losses (``gen_step_grads``) within ``TOL_TTS_GRAD`` of each tensor's scale; the same gate
    must reject two planted faults of the VJP (dβ negated in every snake; dx negated in the
    post snake)."""
    from speechflow_torch.models.vocoder.criterion import vocoder_gen_criterion
    from speechflow_torch.training.trainer import _place

    t0 = time.perf_counter()
    p = model.params
    crit = vocoder_gen_criterion(p.sample_rate, p.n_mels, adv_weight=0.0, fm_weight=0.0)
    model.train()
    no_dropout(model)
    args = (crit, _place(inputs, torch.device("cuda")), _place(targets, torch.device("cuda")),
            None)
    pins = {}
    with plain_versions(), pinned_relus(model, pins):
        ref = gen_step_grads(torch, model, *args)
    with counted_vjps() as vjps, pinned_relus(model, pins):
        reset_counts()
        got = gen_step_grads(torch, model, *args)
        launches = read_counts()
    flips = pins["flips"]
    faults = {}
    for name, fault in (("dβ negated in every snake's VJP", planted_dbeta_fault(None)),
                        ("dx negated in the post snake's VJP",
                         planted_dbeta_fault(model.head.post_act.beta, "dx"))):
        with pinned_relus(model, pins), fault:
            faults[name] = tts_disagreement(ref, gen_step_grads(torch, model, *args))
    wav_err = ((got[2] - ref[2]).abs().max() / ref[2].abs().max()).item()
    loss_err, grad_err, where = tts_disagreement(ref, got)
    print(f"[e2e_train] ft gate: the trained _ft generator, one f32 step (B"
          f"{ref[2].shape[0]}, {tuple(ref[2].shape)} samples, TF32 off, dropout 0; "
          f"{time.perf_counter() - t0:.1f} s), kernels vs plain: waveform {wav_err:.3g} of "
          f"scale (tol {TOL_F32_REL:g}); losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f", worst error {loss_err:.3g} of the loss (tol {TOL_F32_REL:g}); {len(ref[1])} "
          f"gradients, worst {grad_err:.3g} of scale ({where}; tol {TOL_TTS_GRAD:g}); the "
          f"kernels' run: launches {launches}, fused VJPs {vjps['vjp']}; ReLU pre-activations "
          f"on the other side of 0, pinned to the plain run's: {flips}; planted faults: "
          + "; ".join(f"{k}: loss {v[0]:.3g}, gradient {v[1]:.3g} ({v[2]})"
                      for k, v in faults.items()), flush=True)
    check(launches["anti_alias_snake"] > 0 and vjps["vjp"] > 0,
          f"e2e_train ft gate: no anti-alias kernel under autograd: {launches}, {vjps}")
    check(wav_err <= TOL_F32_REL and loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"e2e_train ft gate: kernels disagree with plain: waveform {wav_err}, loss "
          f"{loss_err}, {where} {grad_err}")
    for name, (f_loss, f_grad, _) in faults.items():
        check(max(f_loss / TOL_F32_REL, f_grad / TOL_TTS_GRAD) > 1,
              f"the e2e_train ft gate passes a planted fault ({name})")
    return {"wav_err": wav_err, "loss_err": loss_err, "grad_err": grad_err,
            "fault_grad_err": {k: v[1] for k, v in faults.items()}}


def e2e_serve_layers(torch, model, text: dict, caught: list, ref) -> dict:
    """Where the served E2E waveform's kernels-vs-plain difference comes from. The
    kernels feed the acoustic model, whose outputs (the mel and the frame F0 of each run,
    ``caught``) must agree within ``TOL_F32_REL`` of their scale. The vocoder then runs
    from the plain run's outputs with one of them swapped for the kernels' run's, the
    same sine draws: with the F0 held at the plain run's, the waveform within
    ``TOL_F32_REL`` of its scale. Beside it, the vocoder's own gain from the mel to the
    waveform: its response to the kernels' mel difference with each element's sign drawn
    at random (the same magnitudes, no direction of the kernels')."""
    (mel_k, f0_k), (mel_p, f0_p) = caught

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    cond = text.get("speaker_emb")
    style = text.get("style_emb", cond)

    def vocode(mel, f0):
        return model.from_features(mel, cond, f0, style,
                                   generator=torch.Generator("cuda").manual_seed(0))

    signs = torch.randint(0, 2, mel_p.shape, generator=torch.Generator().manual_seed(3))
    scrambled = mel_p + (mel_k - mel_p) * (2 * signs - 1).to(mel_p)
    with torch.no_grad():
        again, fixed_f0, f0_only = vocode(mel_p, f0_p), vocode(mel_k, f0_p), vocode(mel_p, f0_k)
        random_dir = vocode(scrambled, f0_p)
    out = {"mel": rel(mel_k, mel_p), "f0": rel(f0_k, f0_p), "replay": rel(again, ref),
           "f0_fixed": rel(fixed_f0, again), "f0_only": rel(f0_only, again),
           "random_sign": rel(random_dir, again), "f0_hz": (f0_k - f0_p).abs().max().item(),
           "f0_max_hz": f0_p.max().item(), "voiced": (f0_p > 0).float().mean().item()}
    out["gain"] = out["f0_fixed"] / max(out["mel"], 1e-30)
    print(f"[e2e_train] served batch by layer, kernels vs plain (of each tensor's scale): the "
          f"acoustic model's mel {out['mel']:.3g}, frame F0 {out['f0']:.3g} "
          f"({out['f0_hz']:.3g} Hz at most; the plain run's F0 at most {out['f0_max_hz']:.4g} "
          f"Hz, {out['voiced']:.3g} of the frames above 0; tol {TOL_F32_REL:g}); the vocoder "
          f"from the plain run's outputs replays its waveform to {out['replay']:.3g}; the "
          f"kernels' mel with the F0 held at the plain run's {out['f0_fixed']:.3g} (tol "
          f"{TOL_F32_REL:g}; {out['gain']:.3g} x the mel's), the same mel difference with "
          f"random signs {out['random_sign']:.3g}; the kernels' F0 alone {out['f0_only']:.3g}",
          flush=True)
    check(out["mel"] <= TOL_F32_REL and out["f0"] <= TOL_F32_REL
          and out["f0_fixed"] <= TOL_F32_REL,
          f"e2e_train: the served batch's layers disagree, kernels vs plain: {out}")
    return out


def phase_e2e_train(torch, gpu_line: str) -> dict:
    """``configs/vocoder_styletts2_e2e.yml`` at its default width (the acoustic model
    256 wide with 4 + 4 transformer layers inside Vocos 512 x 8 and the NSF-HiFiGAN
    head, 256 channels, style 192; batch 16 of whole utterances of
    ``configs/tts_data_24khz.yml``, f32) through ``train_vocoder``; its generator served
    on a text batch; then ``vocoder_styletts2_e2e_ft.yml`` (the BigVGAN head under
    autograd) with the discriminator warm-started from that run."""
    import dataclasses
    import tempfile

    import numpy as np

    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.tts_features import E2EBatchProcessor
    from speechflow_torch.ops import attention as A
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import model_config_from_info
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_cfg, data_cfg = TV.configs("default", E2E_CONFIG, E2E_DATA_CONFIG, data_root=SEGS)
    m = model_cfg["model"]
    check(m["feature_extractor"] == "tts" and m["head"] == "nsf_hifigan" and m["dim"] == 512
          and m["tts_params"]["encoder_dim"] == 256,
          f"e2e_train: {E2E_CONFIG} read as {m}")
    pipeline = DataPipeline.from_config(data_cfg)
    params = VocosParams.create(m)
    params.tts_params = model_config_from_info({"model": dict(params.tts_params)}, pipeline)
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    inputs, targets = E2EBatchProcessor()(batch)
    torch.manual_seed(0)
    res = {"gate": generator_gate(torch, "e2e_train", Vocos(params), inputs, targets,
                                  inputs["tts_inputs"].mel.shape[1], flip_first_up)}

    def audio_s(b):
        return float(b.mel_lengths.sum()) * HOP / SR

    with tempfile.TemporaryDirectory() as tmp:
        run = gan_run(torch, "e2e_train", TV.train, model_cfg, data_cfg, E2E_STEPS, tmp,
                      audio_s)
        ckpt = ExperimentSaver.get_last_checkpoint(run["expr"])
        check(ckpt is not None, f"e2e_train: no checkpoint in {run['expr']}")
        tree, payload = ExperimentSaver.load_checkpoint(ckpt)
        vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")
        rows = [s.copy() for s in pipeline.datasets["test"][:E2E_SERVE_ROWS]]
        text, _ = E2EBatchProcessor(device="cuda")(pipeline.datasample_to_batch(rows))
        text["tts_inputs"] = dataclasses.replace(text["tts_inputs"], mel=None, mel_lengths=None,
                                                 durations=None)
        tok = text["tts_inputs"].transcription_lengths.tolist()
        # the acoustic model's outputs (mel, frame F0) of each run, for the layer checks
        caught = []
        hook = vi.model.feature_extractor.register_forward_hook(
            lambda mod, args, out: caught.append((out[0], out[2]["pitch"])))
        with injected_frames(torch, E2E_FRAMES), torch.no_grad():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = vi.model(text, generator=torch.Generator("cuda").manual_seed(0))[0]
            torch.cuda.synchronize()
            serve_ms = 1e3 * (time.perf_counter() - t0)
            serve_counts = read_counts()
            with plain_versions():
                ref = vi.model(text, generator=torch.Generator("cuda").manual_seed(0))[0]
        hook.remove()
        err, lim = (wav - ref).abs().max().item(), rel_limit(ref)
        print(f"[e2e_train] {ckpt.name} -> VocoderEvaluationInterface (E2E generator, f32) on "
              f"a text batch of {len(tok)} test utterances ({tok} tokens, {E2E_FRAMES} frames "
              f"a token injected, max_output_length frames): waveform {tuple(wav.shape)} in "
              f"{serve_ms:.1f} ms (first call); launches {serve_counts}; kernels vs plain: "
              f"max_abs_err {err:.3g} (tol {lim:.3g}) ({gpu_line})", flush=True)
        check(bool(torch.isfinite(wav).all()) and err <= lim,
              "e2e_train: the served generator's kernels disagree with the plain versions")
        res["serve"] = e2e_serve_layers(torch, vi.model, text, caught, ref)
        layers = m["tts_params"]["encoder_layers"] + m["tts_params"]["decoder_layers"]
        check(serve_counts["fused_attention"] == layers,
              f"e2e_train: {serve_counts['fused_attention']} attention launches, not one a "
              f"transformer layer ({layers})")
        # the served batch's attention calls, timed at their shapes: the encoder over the
        # tokens, the decoder over max_output_length frames, E2E_FRAMES a valid token
        tts_p = vi.model.feature_extractor.tts.p
        gen = torch.Generator(device="cuda").manual_seed(6)
        b, t_tok = text["tts_inputs"].transcription.shape
        res["attn"] = {}
        for label, t_len, lens, calls, h, dh in (
                ("encoder", t_tok, tok, tts_p.encoder_layers, tts_p.encoder_heads,
                 tts_p.encoder_dim // tts_p.encoder_heads),
                ("decoder", tts_p.max_output_length, [E2E_FRAMES * n for n in tok],
                 tts_p.decoder_layers, tts_p.decoder_heads,
                 tts_p.decoder_dim // tts_p.decoder_heads)):
            ms, plain, lib, bms, kind, _ = attention_times(torch, A, b, t_len, h, dh, lens,
                                                           torch.float32, gen)
            res["attn"][label] = (ms, plain, lib, bms)
            print(f"[e2e_train] fused_attention e2e {label} B{b} T{t_len} H{h} dh{dh} f32 (valid "
                  f"{lens}): kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
                  f"{bms:.5f} ms ({kind}); {calls} launches a served batch", flush=True)
        del vi, tree, wav, ref, run["trainer"]
        torch.cuda.empty_cache()

        ft_cfg, _ = TV.configs("default", E2E_FT_CONFIG, E2E_DATA_CONFIG, data_root=SEGS)
        check(ft_cfg["model"]["head"] == "snake_upsample",
              f"e2e_train: {E2E_FT_CONFIG} read as {ft_cfg['model']}")
        ft_cfg["warmstart"] = {"disc_from": run["expr"]}
        with counted_vjps() as vjps, tempfile.TemporaryDirectory() as tmp2:
            ft = gan_run(torch, "e2e_train ft", TV.train, ft_cfg, data_cfg, E2E_FT_STEPS, tmp2,
                         audio_s)
        vjp_kernels = read_vjp_counts()  # since the run's reset_counts
        per_step = {k: v / E2E_FT_STEPS for k, v in ft["launches"].items()}
        print(f"[e2e_train] {E2E_FT_CONFIG} (discriminator warm-started from the E2E run): "
              f"anti-alias launches a step {per_step}, fused VJPs {vjps['vjp']} "
              f"({vjps['vjp'] / E2E_FT_STEPS:.0f} a step), VJP kernel launches {vjp_kernels}",
              flush=True)
        check(ft["launches"]["anti_alias_snake"] > 0 and vjps["vjp"] > 0
              and vjp_kernels["anti_alias_snake_vjp"] == vjps["vjp"],
              f"e2e_train: the ft recipe's fused VJPs did not all run the kernel: "
              f"{ft['launches']}, {vjps}, {vjp_kernels}")
        res["ft_gate"] = ft_kernel_gate(torch, ft["trainer"].generator, inputs, targets)
        del ft["trainer"]
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[e2e_train] phase wall time {phase_s:.1f} s", flush=True)
    launches = {k: run["launches"][k] + serve_counts[k] + ft["launches"][k]
                for k in serve_counts}
    res.update(launches=launches, ms=run["ms"], audio_rate=run["audio_rate"],
               peak=run["peak"], ft_ms=ft["ms"], ft_vjps=vjps["vjp"], serve_ms=serve_ms,
               phase_s=phase_s)
    return res


# -- phase 21: the vocoder recipes that raised (NSF, mel_dac, IMDCT, DAC, bio, MOS) ------

NSF_CONFIG, NSF_DATA = "configs/vocoder_nsf.yml", "configs/vocoder_nsf_data_24khz.yml"
DAC_CONFIG = "configs/vocoder_mel_dac.yml"
NSF_STEPS = 8   # the cut: 8 micro-batches, one optimizer step at grad_accum 8
DAC_STEPS = 2
MOS_STEPS = 10


def _chunks_with_f0(n: int, length: int = 24064):
    """``n`` 1 s SEGS chunks and their host YIN F0 (80-880 Hz), a frame a hop."""
    import numpy as np

    from speechflow_torch.data.processors.np_dsp import yin_f0_np

    wav = _seg_waves(n, length)
    f0 = np.stack([yin_f0_np(w, SR, HOP, 2048, 80.0, 880.0, 0.2) for w in wav])
    return wav, f0.astype(np.float32)


def head_step(torch, label: str, params: dict, wav) -> dict:
    """One GAN micro-batch (the recipe's discriminators and losses, AdamW) and one
    inference call card vs CPU of a fresh ``Vocos`` with ``params``."""
    import copy

    import numpy as np

    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import TrainerConfig

    torch.manual_seed(0)
    p = VocosParams.create(params)
    cpu = Vocos(p).eval()
    gen = copy.deepcopy(cpu).to("cuda")
    gan = GANTrainer(gen, VocoderDiscriminator().to("cuda"),
                     vocoder_gen_criterion(p.sample_rate, p.n_mels), vocoder_disc_criterion(),
                     lambda b: ({"waveform": b}, {"waveform": b}),
                     gen_optimizer=OptimizerConfig(lr=1e-4), disc_optimizer=OptimizerConfig(),
                     config=TrainerConfig(max_steps=1))
    x = torch.from_numpy(wav).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = {k: float(v) for k, v in gan.training_step(x).items()}
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    check(all(np.isfinite(v) for v in losses.values()), f"{label}: non-finite {losses}")
    mel = torch.randn(2, 64, p.n_mels, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = cpu.from_features(mel)
        t0 = time.perf_counter()
        got = copy.deepcopy(cpu).to("cuda").from_features(mel.cuda()).cpu()
        infer_ms = 1e3 * (time.perf_counter() - t0)
    err, lim = (got - ref).abs().max().item(), rel_limit(ref)
    print(f"[vocoder_recipes] {label} (dim {p.dim}, f32): a GAN micro-batch of "
          f"{tuple(wav.shape)} in {step_ms:.1f} ms (first call), gen/total "
          f"{losses['gen/total']:.4g}, disc/total {losses['disc/total']:.4g}; inference of "
          f"{tuple(mel.shape)} -> {tuple(got.shape)}, card vs CPU max_abs_err {err:.3g} "
          f"(tol {lim:.3g})", flush=True)
    check(got.shape == (2, 63 * p.hop_length) and err <= lim,
          f"{label}: the card disagrees with the CPU")
    del gan, gen
    return {"step_ms": step_ms, "err": err}


def phase_vocoder_recipes(torch, gpu_line: str) -> dict:
    """The vocoder recipes that raised until now, at their default widths, on the
    card: ``vocoder_nsf.yml`` trained and served (F0 of a TTS output, YIN F0),
    ``nsf_istft`` inference, ``vocoder_mel_dac.yml`` trained and resynthesized, the
    IMDCT (both) and DAC heads, a GAN step with ``bio_ckpt``, and the MOS proxy
    trained and hooked into a validation. No hand kernel runs on these paths."""
    import copy
    import tempfile

    import numpy as np

    from speechflow_torch.data.processors.np_dsp import yin_f0_np
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.biometric.ecapa import ECAPAEmbedder, ECAPAParams
    from speechflow_torch.models.tts.data_types import TTSOutput
    from speechflow_torch.models.vocoder import Vocos, VocosParams, mos_proxy
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.ops import mel as M
    from speechflow_torch.ops import stft as S
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import TrainerConfig
    from speechflow_torch.utils.state_io import save_module

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    nsf_cfg, nsf_data = TV.configs("default", NSF_CONFIG, NSF_DATA, data_root=SEGS)
    check(nsf_cfg["model"]["head"] == "nsf_hifigan" and nsf_cfg["model"]["dim"] == 512,
          f"vocoder_recipes: {NSF_CONFIG} read as {nsf_cfg['model']}")
    wav2, f02 = _chunks_with_f0(2)
    torch.manual_seed(0)
    inputs = {"waveform": torch.from_numpy(wav2), "pitch": torch.from_numpy(f02)}
    res["nsf_gate"] = generator_gate(torch, "vocoder_recipes nsf",
                                     Vocos(VocosParams.create(nsf_cfg["model"])), inputs,
                                     {"waveform": inputs["waveform"]}, f02.shape[1],
                                     flip_first_up)

    def chunk_s(b):
        return b.waveform.shape[0] * b.waveform.shape[1] / SR

    with tempfile.TemporaryDirectory() as tmp:
        nsf = gan_run(torch, "vocoder_recipes nsf", TV.train, nsf_cfg, nsf_data, NSF_STEPS,
                      tmp, chunk_s)
        tree, payload = ExperimentSaver.load_checkpoint(
            ExperimentSaver.get_last_checkpoint(nsf["expr"]))
        vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")
        wav = _seg_waves(1, 64 * HOP * 4, offset=0)[0]
        with torch.no_grad():
            mel = M.amp_to_db(M.linear_to_mel(S.magnitude(torch.from_numpy(wav)[None]), SR,
                                              vi.params.n_mels))
        t = mel.shape[1]
        tokens = t // 8
        attn = torch.zeros(1, t, tokens + 1)
        attn[0, torch.arange(t), torch.clamp(torch.arange(t) // 8, max=tokens)] = 1.0
        f0 = torch.from_numpy(yin_f0_np(wav, SR, HOP, 2048, 80.0, 880.0, 0.2))[None].float()
        tok_pitch = (attn[0].T @ f0[0, :t]) / attn[0].sum(0).clamp(min=1)
        out = TTSOutput(spectrogram=mel[None], attention=attn,
                        variance_predictions={"aggregate_pitch": tok_pitch[None]})
        t0 = time.perf_counter()
        syn = vi.synthesize(out).data
        syn_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        resyn = vi.resynthesize(AudioChunk(data=wav, sr=SR)).data
        resyn_ms = 1e3 * (time.perf_counter() - t0)
        print(f"[vocoder_recipes] nsf -> VocoderEvaluationInterface: synthesize of a TTS "
              f"output ({t} frames, {tokens + 1} tokens of 8 frames, its token pitch through "
              f"the attention) {syn.shape} in {syn_ms:.1f} ms; resynthesize "
              f"{len(wav) / SR:.2f} s with the host's YIN F0 in {resyn_ms:.1f} ms", flush=True)
        check(syn.shape == ((t - 1) * HOP,) and resyn.shape == wav.shape
              and bool(np.isfinite(syn).all() and np.isfinite(resyn).all()),
              "vocoder_recipes: the NSF interface's outputs")
        del vi, tree, nsf["trainer"]
        res.update(nsf_ms=nsf["ms"], nsf_rate=nsf["audio_rate"], nsf_peak=nsf["peak"])

        torch.manual_seed(0)
        istft_p = dict(nsf_cfg["model"], head="nsf_istft")
        cpu = Vocos(VocosParams.create(istft_p)).eval()
        f0 = torch.from_numpy(f02)
        feats = torch.randn(2, f02.shape[1], cpu.params.n_mels,
                            generator=torch.Generator().manual_seed(3))
        draws = cpu.head.sine_gen.draw(2, f02.shape[1] * HOP, "cpu",
                                       torch.Generator().manual_seed(4))
        with torch.no_grad():
            ref = cpu.from_features(feats, f0=f0, sine_noise=draws)
            got = copy.deepcopy(cpu).cuda().from_features(
                feats.cuda(), f0=f0.cuda(), sine_noise=tuple(d.cuda() for d in draws)).cpu()
        err, lim = (got - ref).abs().max().item(), rel_limit(ref)
        print(f"[vocoder_recipes] nsf_istft inference (dim 512, f32): {tuple(got.shape)}, "
              f"card vs CPU max_abs_err {err:.3g} (tol {lim:.3g})", flush=True)
        check(err <= lim, "vocoder_recipes: nsf_istft disagrees, card vs CPU")

        dac_cfg, dac_data = TV.configs("default", DAC_CONFIG, data_root=SEGS)
        check(dac_cfg["model"]["feature_extractor"] == "codec",
              f"vocoder_recipes: {DAC_CONFIG} read as {dac_cfg['model']}")
        dac = gan_run(torch, "vocoder_recipes mel_dac", TV.train, dac_cfg, dac_data,
                      DAC_STEPS, tmp + "/dac", chunk_s)
        tree, payload = ExperimentSaver.load_checkpoint(
            ExperimentSaver.get_last_checkpoint(dac["expr"]))
        vi = VocoderEvaluationInterface.from_checkpoint(tree, payload, device="cuda")
        resyn = vi.resynthesize(AudioChunk(data=wav, sr=SR)).data
        hop = vi.params.hop_length  # the codec's latents: N / hop frames, (frames - 1)·hop out
        print(f"[vocoder_recipes] mel_dac -> resynthesize {len(wav) / SR:.2f} s: "
              f"{resyn.shape}", flush=True)
        check(resyn.shape == ((len(wav) // hop - 1) * hop,) and bool(np.isfinite(resyn).all()),
              "vocoder_recipes: mel_dac's resynthesis")
        del vi, tree, dac["trainer"]
        res.update(dac_ms=dac["ms"], dac_rate=dac["audio_rate"], dac_peak=dac["peak"])
    torch.cuda.empty_cache()

    wav4, _ = _chunks_with_f0(4)
    base = dict(feature_extractor="mel", backbone="vocos", dim=512, n_layers=8)
    for label, opt in (("imdct_symexp", dict(head="imdct_symexp", hop_length=512)),
                       ("imdct_cos", dict(head="imdct_cos", hop_length=512)),
                       ("dac", dict(head="dac"))):
        res[label] = head_step(torch, label, dict(base, **opt), wav4)

    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(0)
        ep = ECAPAParams(n_mels=80)
        bio = str(save_module(ECAPAEmbedder(ep), ep, Path(tmp) / "ecapa.pkl"))
        torch.manual_seed(0)
        gen = Vocos(VocosParams()).cuda()
        gan = GANTrainer(gen, VocoderDiscriminator().cuda(),
                         vocoder_gen_criterion(bio_ckpt=bio, device="cuda"),
                         vocoder_disc_criterion(), lambda b: ({"waveform": b}, {"waveform": b}),
                         config=TrainerConfig(max_steps=1))
        losses = {k: float(v) for k, v in gan.training_step(torch.from_numpy(wav4).cuda()).items()}
        print(f"[vocoder_recipes] GAN step with bio_ckpt (a seeded ECAPA, 80 mels, 256 "
              f"channels, save_module): gen/spk_sim {losses['gen/spk_sim']:.4g}", flush=True)
        check("gen/spk_sim" in losses and np.isfinite(losses["gen/spk_sim"]),
              f"vocoder_recipes: bio_ckpt step {losses}")
        del gan, gen

    waves = [AudioChunk(file_path=f).load(sr=SR).waveform for f in sorted(SEGS.rglob("*.wav"))]
    t0 = time.perf_counter()
    mos = mos_proxy.train_mos_proxy(waves, SR, steps=MOS_STEPS, batch=8, device="cuda")
    mos_s = time.perf_counter() - t0
    torch.manual_seed(0)
    gan = GANTrainer(Vocos(VocosParams()).cuda(), VocoderDiscriminator().cuda(),
                     vocoder_gen_criterion(), vocoder_disc_criterion(),
                     lambda b: ({"waveform": b}, {"waveform": b}),
                     config=TrainerConfig(val_batches=1), mos_hook=mos_proxy.MOSProxyHook(mos))
    val = gan.validate([torch.from_numpy(wav4).cuda()])
    print(f"[vocoder_recipes] train_mos_proxy: {MOS_STEPS} Adam steps of 8 x 1 s chunks of the "
          f"{len(waves)} SEGS utterances in "
          f"{mos_s:.1f} s; hooked into a GAN validation: val/mos {val.get('val/mos')}",
          flush=True)
    check(1.0 <= val.get("val/mos", 0.0) <= 5.0, f"vocoder_recipes: validation {val}")
    del gan, mos
    torch.cuda.empty_cache()
    launches = {k: nsf["launches"][k] + dac["launches"][k] for k in nsf["launches"]}
    phase_s = time.perf_counter() - t_phase
    print(f"[vocoder_recipes] launches {launches}: no hand kernel runs on these paths "
          f"(NSF, iSTFT, MDCT and codec heads; no snake); phase wall time {phase_s:.1f} s "
          f"({gpu_line})", flush=True)
    res.update(launches=launches, phase_s=phase_s)
    return res


# -- phase 22: the forced aligner's two stages through the annotator ---------------------

ALIGNER_DATA2 = "configs/aligner_data_stage2.yml"
ALIGNER_STEPS = 3  # the cut: 3 of the recipe's 200,000 steps a stage


@contextlib.contextmanager
def pinned_path(module, path):
    """``maximum_path`` in the aligner's module returning ``path`` (on the caller's
    device), recording the path it would have found in ``module.own``."""
    from speechflow_torch.models.aligner import model as AM

    real = AM.maximum_path

    def pinned(value, *args):
        module.own = real(value, *args)
        return path.to(value.device, value.dtype)

    AM.maximum_path = pinned
    try:
        yield
    finally:
        AM.maximum_path = real


@contextlib.contextmanager
def planted_squeeze_fault(torch):
    """The flow's squeeze stacking the two halves of the utterance on the channels
    in place of interleaving frame pairs (a fault the gate must see)."""
    from speechflow_torch.models.aligner.flows import FlowSpecDecoder

    real = FlowSpecDecoder.__dict__["_squeeze"]

    def halves(x, lengths):
        t2 = x.shape[1] // 2
        return torch.cat([x[:, :t2], x[:, t2:2 * t2]], dim=-1), lengths // 2

    FlowSpecDecoder._squeeze = staticmethod(halves)
    try:
        yield
    finally:
        FlowSpecDecoder._squeeze = real


def aligner_grads(torch, model, inputs, targets) -> tuple:
    from speechflow_torch.models.aligner import AlignerCriterion

    for p in model.parameters():
        p.grad = None
    out = model(inputs, training=True)
    losses = AlignerCriterion()(out, targets, 0)
    sum(losses.values()).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
             for n, p in model.named_parameters()}), out["path"].detach().cpu()


def aligner_gate(torch, model_cfg: dict, data_cfg: dict) -> dict:
    """One f32 training step of ``configs/aligner_model.yml`` at its default width on
    the card and on the CPU: the same seeded weights (the couplings' zero output convs
    drawn at std 0.02, so every coupling trains), dropout 0, the first two train
    utterances, TF32 off. The card's own MAS path must equal the CPU's (durations
    exact); losses within ``TOL_F32_REL``, every gradient within ``TOL_TTS_GRAD``; a
    planted fault (the squeeze stacking halves) must be rejected. Also counts the
    token durations that move on the card with TF32 on."""
    import copy

    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.models.aligner import AlignerBatchProcessor, GlowTTSAligner, GlowTTSParams
    from speechflow_torch.scripts.common import model_config_from_info

    t0 = time.perf_counter()
    pipeline = DataPipeline.from_config(data_cfg)
    params = GlowTTSParams.create(model_config_from_info(model_cfg, pipeline))
    torch.manual_seed(0)
    cpu = GlowTTSAligner(params)
    for cp in cpu.flow.couplings:
        torch.nn.init.normal_(cp.post.weight, std=0.02)
    no_dropout(cpu)
    card = copy.deepcopy(cpu).to("cuda")
    batch = pipeline.datasample_to_batch([s.copy() for s in pipeline.datasets["train"][:2]])
    inputs, targets = AlignerBatchProcessor()(batch)
    ref, path = aligner_grads(torch, cpu, inputs, targets)
    zero = [k for k, v in ref[1].items() if not v.any()]
    check(not zero, f"aligner: reference gradients all zero: {zero}")
    ci, ct = _on(inputs, "cuda"), _on(targets, "cuda")
    with pinned_path(card, path):
        got, _ = aligner_grads(torch, card, ci, ct)
    moved = int((card.own.cpu().sum(-1) != path.sum(-1)).sum())
    with pinned_path(card, path), planted_squeeze_fault(torch):
        bad, _ = aligner_grads(torch, card, ci, ct)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32 = card(ci, training=True)["durations"].cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    moved_tf32 = int((tf32 != path.sum(-1)).sum())
    loss_err, grad_err, where = tts_disagreement(ref, got)
    f_loss, f_grad, f_where = tts_disagreement(ref, bad)
    n_tok = int(inputs.transcription_lengths.sum())
    print(f"[aligner] f32 step at default width, card vs CPU (seeded, B2, mel "
          f"{tuple(inputs.mel.shape)}, tokens {tuple(inputs.transcription.shape)}, TF32 off, "
          f"dropout 0; {time.perf_counter() - t0:.1f} s): losses "
          + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f"; worst loss error {loss_err:.3g} (tol {TOL_F32_REL:g}); {len(ref[1])} "
          f"gradients, worst {grad_err:.3g} of scale ({where}; tol {TOL_TTS_GRAD:g}); token "
          f"durations of the card's own path that differ from the CPU's: {moved} of {n_tok} "
          f"(TF32 off), {moved_tf32} with TF32 on; planted fault (squeeze by halves): loss "
          f"{f_loss:.3g}, gradient {f_grad:.3g} ({f_where})", flush=True)
    check(moved == 0, f"aligner: {moved} token durations differ, card vs CPU, TF32 off")
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"aligner f32: the card disagrees with the CPU: loss {loss_err}, {where} {grad_err}")
    check(max(f_loss / TOL_F32_REL, f_grad / TOL_TTS_GRAD) > 1,
          "the aligner gate passes a planted fault (squeeze by halves)")
    del cpu, card
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_err": grad_err, "fault_grad_err": f_grad,
            "moved_tf32": moved_tf32, "tokens": n_tok}


def aligner_stage(torch, label: str, TA, model_cfg: dict, data_cfg: dict, tmp: str,
                  root: Path, stage) -> dict:
    """One stage: ``train_aligner.train`` for ``ALIGNER_STEPS`` steps (``timed_fit``), then
    the ``Aligner`` over ``root`` (the stage's input grids), timed."""
    from speechflow_torch.annotator.align import Aligner
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer

    def work(batch):
        frames = int(batch.mel_lengths.sum())
        return frames, f"mel {tuple(batch.mel.shape)}, {frames} frames"

    run = timed_fit(torch, f"aligner {label}", Trainer, TA.train, model_cfg, data_cfg,
                    ALIGNER_STEPS, tmp, work)
    expr, t_fit, ms, rate, peak = (run[k] for k in ("expr", "t_fit", "ms", "rate", "peak"))
    train_counts = run["launches"]
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    al = Aligner(ckpt, batch_size=16, device="cuda")
    files = sorted(root.rglob(f"*{stage.input_ext}"))
    if stage.input_ext == ".TextGrid":
        files = [f for f in files if ".TextGridStage" not in f.name]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = al.run(root, stage)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    align_counts = read_counts()
    print(f"[aligner] {label}: {t_fit:.1f} s with set-up; {ms:.1f} ms a step (median of "
          f"2..{ALIGNER_STEPS}), {rate:.0f} mel frames trained per second, peak device memory "
          f"{peak / 2**30:.2f} GiB, training launches {train_counts}; Aligner {stage.name} "
          f"over {len(files)} grids: {len(written)} written in {align_s:.2f} s "
          f"({1e3 * align_s / max(len(written), 1):.1f} ms an aligned utterance), launches "
          f"{align_counts}", flush=True)
    check(len(written) > 0, f"{label}: the Aligner wrote nothing")
    return {"ckpt": ckpt, "aligner": al, "files": files, "written": written, "ms": ms,
            "frame_rate": rate, "peak": peak, "align_s": align_s,
            "launches": {k: train_counts[k] + align_counts[k] for k in align_counts}}


def aligner_kernels_vs_plain(torch, label: str, what: str, aligner, files,
                             gpu_line: str) -> tuple:
    """The encoder and ``align`` of an ``Aligner``'s model over a batch of (up to 16 of)
    ``files``, f32, through the kernels and under ``plain_versions()``: mu, logstd and
    log-duration within ``TOL_F32_REL`` of scale, the durations equal, one launch a
    layer a call; one attention call at the batch's shape timed. Returns (the times,
    the launches of the two kernel calls)."""
    from speechflow_torch.ops import attention as A

    model = aligner.model
    _, inputs = aligner.batch_inputs(files[:16])
    inputs = inputs.to("cuda", torch.float32)
    with torch.no_grad():
        reset_counts()
        h = model.encode_text(inputs, training=False)
        d = model.align(inputs)[0]
        counts = read_counts()
        with plain_versions():
            h_ref = model.encode_text(inputs, training=False)
            d_ref = model.align(inputs)[0]
    err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for a, b in zip(h, h_ref))
    lens = inputs.transcription_lengths.tolist()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, t = inputs.transcription.shape
    heads = model.p.encoder_heads
    dh = model.p.encoder_dim // heads
    ms, plain, lib, bms, kind, _ = attention_times(torch, A, b, t, heads, dh, lens,
                                                   torch.float32, gen)
    print(f"[{label}] encoder of {what} (B{b} T{t} H{heads} dh{dh}, tokens {lens}), f32: "
          f"kernels vs plain: worst of mu, logstd, log-duration {err:.3g} of scale (tol "
          f"{TOL_F32_REL:g}), durations equal {bool(torch.equal(d, d_ref))}; "
          f"{counts['fused_attention']} launches for two calls; one attention call: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({kind}) "
          f"({gpu_line})", flush=True)
    check(err <= TOL_F32_REL and torch.equal(d, d_ref)
          and counts["fused_attention"] == 2 * model.p.encoder_layers,
          f"{label}: dh-{dh} attention kernels vs plain: {err}, {counts}")
    return ({"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
             "shape": (b, t, heads, dh), "err": err}, counts)


def phase_aligner(torch, gpu_line: str) -> dict:
    """``configs/aligner_model.yml`` at its default width (192 wide, 4 layers of 2
    heads of 96, 6 flows) trained on ``aligner_data_stage1.yml`` over the raw
    ``.TextGrid`` of a copy of ``tests/data/SEGS``; the annotator's ``Aligner`` writes
    ``.TextGridStage1``, each read back. The encoder attends through the fused kernel
    (dh 96) when it aligns. (The annotator phase runs both stages through the runner.)"""
    import tempfile

    import numpy as np

    from speechflow_torch.annotator.align import AlignStage
    from speechflow_torch.io.seg import AudioSeg
    from speechflow_torch.scripts import train_aligner as TA

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "SEGS"
        shutil.copytree(SEGS, root, ignore=shutil.ignore_patterns("*.TextGridStage*"))
        model_cfg, data_cfg = TA.configs("default", data_root=root)
        m = model_cfg["model"]
        check(m["encoder_dim"] == 192 and m["encoder_heads"] == 2 and m["n_flows"] == 6,
              f"aligner: {TA.MODEL_CONFIG} read as {m}")
        res["gate"] = aligner_gate(torch, model_cfg, data_cfg)
        s1 = aligner_stage(torch, "stage 1", TA, model_cfg, data_cfg, tmp + "/e1", root,
                           AlignStage.stage1)

        # the stage's dh-96 attention through the kernels and the plain versions
        res["attn"], counts = aligner_kernels_vs_plain(torch, "aligner", "a stage-1 batch",
                                                       s1["aligner"], s1["files"], gpu_line)

        n_ivs = []
        for p in s1["written"]:
            seg = AudioSeg.load(p)
            ivs = seg.phonemes()
            times = np.asarray([iv[:2] for iv in ivs])
            check(len(ivs) > 0 and bool((np.diff(times[:, 0]) >= 0).all())
                  and times[-1, 1] <= seg.duration + 1e-6,
                  f"aligner: {p.name} reads back wrong")
            n_ivs.append(len(ivs))
        print(f"[aligner] {len(s1['written'])} .TextGridStage1 read back with AudioSeg.load: "
              f"{sum(n_ivs)} phoneme intervals", flush=True)
        check(all(p.suffix == ".TextGridStage1" for p in s1["written"]),
              "aligner: stage 1 wrote the wrong files")
        del s1["aligner"]
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[aligner] phase wall time {phase_s:.1f} s", flush=True)
    launches = {k: s1["launches"][k] + counts[k] for k in counts}
    res.update(launches=launches, ms=s1["ms"], frame_rate=s1["frame_rate"], peak=s1["peak"],
               ms_utt=1e3 * s1["align_s"] / len(s1["written"]), phase_s=phase_s)
    return res


# -- phase 23: the auxiliary models --------------------------------------------------

G2P_HELD = 25  # word types held out: tests/test_g2p.py's split (seed 0's permutation)
G2P_MAX_PER, G2P_MIN_EXACT = 0.31, 0.26  # tests/test_g2p.py's gates
CREPE_TONES = (80.0, 150.0, 220.0, 440.0)  # held tones (tests/test_pitch_crepe.py)
CREPE_MAX_MEDIAN_ERR = 0.03
CREPE_STEPS = 300  # the cut (of JAX's 600): its host batches are most of the phase
CTC_STEPS = 150  # tests/test_asr_ctc.py's synthetic task
DEMUCS_STEPS = 20
CODEC_STEPS, BIOMETRIC_STEPS = 20, 10  # the examples' cut (200 and 60 by default)


def _harmonic(f0: float, seconds: float = 1.0, n_harm: int = 10):
    import numpy as np

    tt = np.arange(int(SR * seconds)) / SR
    sig = sum(k ** -1.0 * np.sin(2 * np.pi * k * f0 * tt) for k in range(1, n_harm + 1))
    return (sig / np.abs(sig).max()).astype(np.float32)


def _seg_wave(i: int = 0):
    """The ``i``-th SEGS utterance at 24 kHz, whole."""
    from speechflow_torch.io.audio import AudioChunk

    return AudioChunk(file_path=sorted(SEGS.rglob("*.wav"))[i]).load(sr=SR).waveform


def aux_g2p(torch, gpu_line: str) -> dict:
    """``train_g2p_artifact`` on SEGS at JAX's defaults (1200 steps x 3 members, the
    BiGRU) with tests/test_g2p.py's held-out split, its PER and exact-match gates; then
    a raw-text request of 4 sentences through ``TTSEvaluationInterface`` at flagship
    width, which finds that ``g2p.pkl`` beside its checkpoint path: its tokens are the
    G2P's phonemes, and it launches the flagship's kernels."""
    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.data.processors.text import SERVICE_TOKENS, G2PParserHook
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.models.g2p import G2P, mine_g2p_lexicon
    from speechflow_torch.scripts import train_g2p as TG

    lexicon = mine_g2p_lexicon(sorted(SEGS.rglob("*.TextGrid*")))
    out_dir = workdir() / "g2p"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = TG.train_g2p_artifact(SEGS, out_dir, steps=1200,
                                 holdout=(G2P_HELD + 0.5) / len(lexicon), seed=0,
                                 device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    g2p = G2P.load(path, device="cuda")
    idx = np.random.default_rng(0).permutation(len(lexicon))
    per, exact = TG.held_out_scores(g2p, [lexicon[i] for i in idx[:G2P_HELD]])
    print(f"[aux_models] G2P: train_g2p_artifact on SEGS ({len(lexicon)} word types, "
          f"{G2P_HELD} held out; 1200 steps x 3 members) in {train_s:.1f} s with mining; "
          f"held-out PER {per:.4f} (gate <= {G2P_MAX_PER}), exact-match {exact:.4f} "
          f"(gate >= {G2P_MIN_EXACT}) ({gpu_line})", flush=True)
    check(per <= G2P_MAX_PER and exact >= G2P_MIN_EXACT,
          f"aux_models: G2P held-out PER {per:.4f} / exact {exact:.4f} fail their gates")

    sentences = list(REQUEST_SENTENCES[:4])
    hook = G2PParserHook(g2p)
    payload = serving.flagship_payload(sorted({s for x in sentences for s in hook(x)}))
    am, vm = serving.build_flagship("default", device="cuda", dtype=torch.float32, seed=0)
    ti = TTSEvaluationInterface(am, payload, ckpt_path=out_dir)
    vi = VocoderEvaluationInterface(vm)
    check(isinstance(ti.text_processor.parser, G2PParserHook),
          "aux_models: the TTS interface did not find the trained g2p.pkl")
    ctx = ti.prepare_embeddings(ti.create_context("EN", ti.get_speakers()[0]))
    reset_counts()
    r = tts_request(torch, ti, vi, sentences, ctx, TTSOptions(t_out=T_FRAMES),
                    gen=torch.Generator(device="cuda").manual_seed(0))
    counts = read_counts()
    ids = r["inputs"].transcription.cpu().numpy()
    lens = r["inputs"].transcription_lengths.cpu().numpy()
    used = {s for row, n in zip(ids, lens) for s in ti.alphabet.decode(row[:n])}
    phones = set(g2p.phoneme_inventory)
    wave = r["wave"]
    print(f"[aux_models] raw text -> G2P -> TTSEvaluationInterface (flagship width, f32): "
          f"{len(sentences)} sentences, {int(lens.sum())} tokens of {len(used)} symbols "
          f"({len(used & phones)} G2P phonemes), {len(wave)} samples in "
          f"{r['ms']['total']:.1f} ms, launches {counts}", flush=True)
    check(used <= phones | set(SERVICE_TOKENS) and len(used & phones) > 10,
          f"aux_models: the request's tokens are not the G2P's phonemes: {sorted(used)[:20]}")
    check(counts == EXPECTED_LAUNCHES, f"aux_models: request launches {counts}")
    check(bool(np.isfinite(wave).all()) and float(wave.std()) > 1e-4,
          "aux_models: the G2P request's waveform is not finite or is silent")
    del am, vm, ti, vi
    torch.cuda.empty_cache()
    return {"launches": counts, "g2p_per": per, "g2p_exact": exact, "g2p_s": train_s}


def aux_crepe(torch, gpu_line: str) -> dict:
    """``train_crepe`` (``CREPE_STEPS`` steps x 64 frames; JAX's default is 600), its median relative
    error on held tones, and the ``pitch`` handler's ``crepe`` (the saved tracker, on
    the card) and ``yingram`` methods on a SEGS utterance."""
    import numpy as np

    from speechflow_torch.data.core.datasample import SpectrogramDataSample
    from speechflow_torch.data.processors import spectral as S
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.pitch import CrepeParams, crepe_f0, save_crepe, train_crepe

    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = train_crepe(CrepeParams(), steps=CREPE_STEPS, batch=64, seed=0, device="cuda",
                        losses=losses)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    errs, voiced = [], []
    with torch.inference_mode():
        for f0 in CREPE_TONES:
            est = crepe_f0(model, torch.from_numpy(_harmonic(f0)[None]).to("cuda"),
                           sr=SR)[0].cpu().numpy()
            voiced.append(float((est > 0).mean()))
            errs.append(abs(float(np.median(est[est > 0])) - f0) / f0 if voiced[-1] else 1.0)
    med = float(np.median(errs))
    print(f"[aux_models] CREPE: train_crepe {CREPE_STEPS} x 64 in {train_s:.1f} s (loss "
          f"{np.mean(losses[:20]):.4f} -> {np.mean(losses[-20:]):.4f}); held tones "
          f"{CREPE_TONES}: voiced {voiced}, relative errors "
          + ", ".join(f"{e:.4f}" for e in errs)
          + f", median {med:.4f} (gate < {CREPE_MAX_MEDIAN_ERR})", flush=True)
    check(min(voiced) > 0.8 and med < CREPE_MAX_MEDIAN_ERR,
          f"aux_models: CREPE tones voiced {voiced}, median relative error {med}")
    ckpt = workdir() / "crepe.pkl"
    save_crepe(model, ckpt)
    wav = _seg_wave(0)
    f0 = S.pitch(SpectrogramDataSample(audio_chunk=AudioChunk(data=wav, sr=SR)),
                 method="crepe", crepe_ckpt=str(ckpt)).pitch
    img = S.pitch(SpectrogramDataSample(audio_chunk=AudioChunk(data=wav, sr=SR)),
                  method="yingram").pitch
    n_frames = 1 + len(wav) // HOP
    print(f"[aux_models] pitch handler on a SEGS utterance ({len(wav) / SR:.2f} s): crepe "
          f"{f0.shape}, voiced {float((f0 > 0).mean()):.3f}, median "
          f"{float(np.median(f0[f0 > 0])) if (f0 > 0).any() else 0.0:.1f} Hz; yingram "
          f"{img.shape} in [{img.min():.3f}, {img.max():.3f}]", flush=True)
    check(f0.shape == (n_frames,) and (f0 >= 0).all() and (f0 > 0).any(),
          "aux_models: the crepe pitch handler")
    check(img.ndim == 2 and img.shape[0] == n_frames and img.min() >= 0.0 and img.max() <= 4.0
          and bool(np.isfinite(img).all()), "aux_models: the yingram pitch handler")
    S._CREPE_CACHE.clear()
    return {"crepe_err": med, "crepe_s": train_s}


def _ctc_task():
    """tests/test_asr_ctc.py's task: two 40-frame, 16-band mel patterns encoding
    [1, 2, 3] and [3, 1, 2]."""
    import numpy as np

    rng = np.random.default_rng(0)
    seqs = [[1, 2, 3], [3, 1, 2]]
    mels = []
    for labels in seqs:
        mel = rng.normal(0, 0.1, (40, 16)).astype(np.float32)
        seg = 40 // len(labels)
        for j, lab in enumerate(labels):
            mel[j * seg:(j + 1) * seg, lab * 3:lab * 3 + 3] += 2.0
        mels.append(mel)
    return np.stack(mels), seqs


def aux_ctc(torch, gpu_line: str) -> dict:
    """The CTC recognizer trained on tests/test_asr_ctc.py's synthetic task
    (``CTCLoss``, adam 3e-3) until greedy decoding returns the sequences; then
    ``CTCPhonemeASR`` over its saved checkpoint on 45 s of SEGS audio (three
    20 s windows)."""
    import numpy as np

    from speechflow_torch.annotator.asr import CTCPhonemeASR
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.asr import CTCRecognizer, CTCRecognizerParams, greedy_ctc_decode
    from speechflow_torch.training.losses import CTCLoss
    from speechflow_torch.training.optimizer import optax_optimizer
    from speechflow_torch.utils.state_io import save_module

    mels, seqs = _ctc_task()
    params = CTCRecognizerParams(n_symbols=5, n_mels=16, dim=48, time_stride=1)
    torch.manual_seed(0)
    model = CTCRecognizer(params).to("cuda").train()
    opt = optax_optimizer(model.parameters(), "adam", 3e-3)
    ctc = CTCLoss(blank_id=0)
    mel = torch.from_numpy(mels).to("cuda")
    tgt = torch.tensor(seqs, device="cuda")
    tgt_lens = torch.tensor([3, 3], device="cuda")
    losses = []
    for _ in range(CTC_STEPS + 1):
        opt.zero_grad(set_to_none=True)
        logits, out_lens = model(mel)
        loss = ctc(logits, tgt, lengths=out_lens, target_lengths=tgt_lens)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    model.eval()
    with torch.inference_mode():
        decoded = [list(greedy_ctc_decode(lg)[0]) for lg in model(mel)[0]]
    print(f"[aux_models] CTC: {CTC_STEPS + 1} steps on the synthetic task, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, greedy decode {decoded} (want {seqs})",
          flush=True)
    check(losses[-1] < 0.2 * losses[0] and decoded == seqs,
          "aux_models: the CTC recognizer did not learn the synthetic task")
    ckpt = save_module(model, params, workdir() / "ctc.pkl")
    wav = np.concatenate([_seg_wave(i) for i in range(12)])[:45 * SR]
    asr = CTCPhonemeASR(ckpt, {1: "A", 2: "B", 3: "C", 4: "D"})
    t0 = time.perf_counter()
    out = asr.transcribe(AudioChunk(data=wav, sr=SR))
    stamps = out["timestamps"]
    print(f"[aux_models] CTCPhonemeASR on {len(wav) / SR:.1f} s: {len(stamps)} tokens in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
    check(set(out) == {"text", "timestamps"} and out["text"] == " ".join(s[0] for s in stamps)
          and len(stamps) > 0 and all(0.0 <= b <= e for _, b, e in stamps)
          and all(a[1] <= b[1] for a, b in zip(stamps, stamps[1:])),
          "aux_models: CTCPhonemeASR's transcript")
    return {"ctc_loss": losses[-1]}


def _noisy_batch(rng, n: int, length: int):
    """``n`` SEGS chunks of ``length`` samples with white noise at 10 dB SNR:
    (noisy, clean) float32."""
    import numpy as np

    clean = _seg_waves(n, length, offset=int(rng.integers(0, SR)))
    noise = rng.standard_normal(clean.shape) * clean.std(-1, keepdims=True) * 10 ** (-10 / 20)
    return (clean + noise).astype(np.float32), clean


def aux_demucs(torch, gpu_line: str) -> dict:
    """``WaveDenoiser`` at its defaults, ``DEMUCS_STEPS`` adam steps under
    ``denoiser_criterion`` on SEGS chunks with noise, then the ``denoise`` handler
    over its saved checkpoint (on the card)."""
    import numpy as np

    from speechflow_torch.data.core.datasample import AudioDataSample
    from speechflow_torch.data.processors.audio import denoise
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.denoiser import WaveDenoiser, WaveDenoiserParams, denoiser_criterion
    from speechflow_torch.training.optimizer import optax_optimizer
    from speechflow_torch.utils.state_io import save_module

    rng = np.random.default_rng(0)
    params = WaveDenoiserParams()
    torch.manual_seed(0)
    model = WaveDenoiser(params).to("cuda").train()
    opt = optax_optimizer(model.parameters(), "adam", 3e-4)
    crit = denoiser_criterion()
    losses = []
    for _ in range(DEMUCS_STEPS):
        noisy, clean = (torch.from_numpy(a).to("cuda") for a in _noisy_batch(rng, 4, 24576))
        opt.zero_grad(set_to_none=True)
        loss = sum(crit(model(noisy), {"clean": clean}, 0).values())
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = [float(v) for v in losses]
    ckpt = save_module(model, params, workdir() / "demucs.pkl")
    noisy, _ = _noisy_batch(rng, 1, 3 * SR + 77)
    out = denoise(AudioDataSample(audio_chunk=AudioChunk(data=noisy[0], sr=SR)),
                  model_ckpt=str(ckpt)).audio_chunk.waveform
    print(f"[aux_models] demucs: {DEMUCS_STEPS} steps (B4 x 1.02 s), loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; the denoise handler over its checkpoint: {out.shape}", flush=True)
    check(all(np.isfinite(losses)) and out.shape == noisy[0].shape
          and bool(np.isfinite(out).all()), "aux_models: demucs training or the denoise handler")
    return {"demucs_loss": losses[-1]}


def aux_cpc(torch, gpu_line: str) -> dict:
    """``train_cpc`` at JAX's defaults (150 steps, 4 x 1 s chunks) on the SEGS waves,
    the loss falling; saved with ``save_module`` (the ``vocoder_cpc`` phase's
    ``loss.cpc_ckpt``) and read back by ``ssl_features(model_ckpt=...)``."""
    import numpy as np

    from speechflow_torch.data.core.datasample import AudioDataSample
    from speechflow_torch.data.processors.embeddings import ssl_features
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.ssl import train_cpc
    from speechflow_torch.utils.state_io import save_module

    waves = [_seg_wave(i) for i in range(len(sorted(SEGS.rglob("*.wav"))))]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = train_cpc(waves, sr=SR, seed=0, device="cuda", losses=losses)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    ckpt = save_module(model, model.p, workdir() / "cpc.pkl")
    _WORK["cpc"] = ckpt
    wav = _seg_wave(1)
    feat = ssl_features(AudioDataSample(audio_chunk=AudioChunk(data=wav, sr=SR)),
                        model_ckpt=str(ckpt)).ssl_feat
    with torch.inference_mode():
        padded = np.pad(wav, (0, (-len(wav)) % (model.hop * 64)))
        ref = model(torch.from_numpy(padded[None].astype(np.float32)).to("cuda"))[0]
        ref = ref[:len(wav) // model.hop].float().cpu().numpy()
    err = float(np.abs(feat - ref).max())
    print(f"[aux_models] CPC: {len(losses)} steps on {len(waves)} SEGS waves in {train_s:.1f} s, "
          f"InfoNCE {first:.4f} -> {last:.4f} (means of the first and last 10); "
          f"ssl_features over the checkpoint {feat.shape}, max_abs_err {err:.3g} against "
          f"the trained model", flush=True)
    check(last < first, "aux_models: the CPC loss did not fall")
    check(feat.shape == ref.shape and err <= TOL_F32_REL * float(np.abs(ref).max()),
          "aux_models: ssl_features does not serve the saved CPC")
    return {"cpc_loss": last, "cpc_s": train_s}


def aux_examples(torch, gpu_line: str) -> dict:
    """The codec and ECAPA examples for a few steps each on the card, each ``--save``
    pickle read back by the handler that serves it."""
    import numpy as np

    from speechflow_torch.data.core.datasample import AudioDataSample
    from speechflow_torch.data.processors.embeddings import codec_features, voice_biometrics
    from speechflow_torch.examples.biometric import train as BT
    from speechflow_torch.examples.codec import train as CT
    from speechflow_torch.io.audio import AudioChunk

    wav = _seg_wave(2)
    out = {}
    for name, mod, steps, handler, field in (
            ("codec", CT, CODEC_STEPS, codec_features, "ac_feat"),
            ("biometric", BT, BIOMETRIC_STEPS, voice_biometrics, "speaker_emb")):
        path = workdir() / f"{name}.pkl"
        t0 = time.perf_counter()
        mod.main(["--steps", str(steps), "--save", str(path)])
        dt = time.perf_counter() - t0
        feat = getattr(handler(AudioDataSample(audio_chunk=AudioChunk(data=wav, sr=SR)),
                               model_ckpt=str(path)), field)
        print(f"[aux_models] examples/{name}/train.py: {steps} steps in {dt:.1f} s; "
              f"{handler.__name__} over its pickle: {feat.shape}", flush=True)
        check(bool(np.isfinite(feat).all()) and feat.shape[-1] == 64,
              f"aux_models: {name} example's pickle through {handler.__name__}")
        out[f"{name}_s"] = dt
    return out


def aux_card_vs_cpu(torch, gpu_line: str) -> dict:
    """One f32 step of CPC, CREPE, CTC and demucs at their defaults on the card and on
    the CPU, TF32 off, the same weights and batch: the loss within ``TOL_F32_REL``, each
    gradient within ``TOL_TTS_GRAD`` of its tensor's scale."""
    import copy

    import numpy as np

    from speechflow_torch.models.asr import CTCRecognizer, CTCRecognizerParams
    from speechflow_torch.models.denoiser import WaveDenoiser, WaveDenoiserParams, denoiser_criterion
    from speechflow_torch.models.pitch import CrepeF0, CrepeParams, synth_pitch_batch
    from speechflow_torch.models.ssl import CPCModel, CPCParams, cpc_infonce_loss
    from speechflow_torch.ops.mel import amp_to_db, linear_to_mel
    from speechflow_torch.ops.stft import magnitude
    from speechflow_torch.training.losses import CTCLoss

    rng = np.random.default_rng(5)
    wav2 = _seg_waves(2, SR)
    frames, targets = synth_pitch_batch(rng, CrepeParams(), 16)
    noisy, clean = _noisy_batch(rng, 2, 16384)
    ctc_params = CTCRecognizerParams()
    labels = rng.integers(1, ctc_params.n_symbols, (2, 12))

    def cpc_loss(m, dev):
        return cpc_infonce_loss(m, torch.from_numpy(wav2).to(dev))

    def crepe_loss(m, dev):
        return torch.nn.functional.binary_cross_entropy_with_logits(
            m(torch.from_numpy(frames).to(dev)), torch.from_numpy(targets).to(dev))

    def ctc_loss(m, dev):
        w = torch.from_numpy(wav2).to(dev)
        mel = amp_to_db(linear_to_mel(magnitude(w, 1024, 256), SR, ctc_params.n_mels))
        logits, lens = m(mel)
        return CTCLoss()(logits, torch.from_numpy(labels).to(dev), lengths=lens)

    def demucs_loss(m, dev):
        out = m(torch.from_numpy(noisy).to(dev))
        return sum(denoiser_criterion()(out, {"clean": torch.from_numpy(clean).to(dev)},
                                        0).values())

    res = {}
    torch.manual_seed(0)
    for name, model, loss_fn in (("cpc", CPCModel(CPCParams()), cpc_loss),
                                 ("crepe", CrepeF0(CrepeParams()), crepe_loss),
                                 ("ctc", CTCRecognizer(ctc_params), ctc_loss),
                                 ("demucs", WaveDenoiser(WaveDenoiserParams()), demucs_loss)):
        runs = []
        for dev, m in (("cpu", model.train()), ("cuda", copy.deepcopy(model).to("cuda"))):
            loss = loss_fn(m, dev)
            loss.backward()
            runs.append((float(loss), {n: p.grad.detach().float().cpu()
                                       for n, p in m.named_parameters() if p.grad is not None}))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = runs
        worst = max(((g_gpu[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
                    for n, g in g_cpu.items())
        print(f"[aux_models] {name} f32 step card vs CPU: loss {l_gpu:.6g} vs {l_cpu:.6g}, "
              f"{len(g_cpu)} gradients, worst relative {worst[0]:.3g} ({worst[1]}; tol "
              f"{TOL_TTS_GRAD:g})", flush=True)
        check(abs(l_gpu - l_cpu) <= TOL_F32_REL * abs(l_cpu) and worst[0] <= TOL_TTS_GRAD
              and set(g_gpu) == set(g_cpu), f"aux_models: {name} card vs CPU: {worst}")
        res[f"{name}_grad_rel"] = worst[0]
    return res


def phase_aux_models(torch, gpu_line: str) -> dict:
    """The auxiliary models' training and serving on the card (see the docstring)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = aux_g2p(torch, gpu_line)
    for part in (aux_crepe, aux_ctc, aux_demucs, aux_cpc, aux_examples, aux_card_vs_cpu):
        t0 = time.perf_counter()
        res.update(part(torch, gpu_line))
        print(f"[aux_models] {part.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[aux_models] phase wall time {res['phase_s']:.1f} s", flush=True)
    return res


# -- phase 24: GAN training of the flagship vocoder with the CPC loss --------------------

CPC_MICRO_BATCHES = 8  # the cut: one optimizer step of the recipe's grad_accum 8


def cpc_checkpoint(torch) -> Path:
    """The CPC that ``aux_models`` trained in this run, else one trained here for 20
    steps (the phase alone)."""
    from speechflow_torch.models.ssl import train_cpc
    from speechflow_torch.utils.state_io import save_module

    if "cpc" not in _WORK:
        model = train_cpc([_seg_wave(i) for i in range(8)], sr=SR, steps=20, seed=0,
                          device="cuda")
        _WORK["cpc"] = save_module(model, model.p, workdir() / "cpc.pkl")
    return _WORK["cpc"]


@contextlib.contextmanager
def planted_cpc_fault():
    """The CPC perceptual loss with its fake branch detached: the term sends no
    gradient to the generator."""
    from speechflow_torch.models.vocoder import criterion as C

    real = C.make_cpc_perceptual_loss

    def faulty(ckpt, device=None):
        loss = real(ckpt, device)

        def detached(fake, wav):
            return loss(fake.detach(), wav)

        detached.model = loss.model
        return detached

    C.make_cpc_perceptual_loss = faulty
    try:
        yield
    finally:
        C.make_cpc_perceptual_loss = real


def cpc_term_grads(torch, gen, disc, crit, wav) -> dict:
    """The generator's gradients of the ``cpc`` term alone (discriminator frozen; 0
    where the term reaches no parameter)."""
    from speechflow_torch.training.gan_trainer import frozen

    for p in gen.parameters():
        p.grad = None
    inputs = {"waveform": wav}
    with frozen(disc):
        term = crit(gen(inputs), disc, inputs, inputs, 0)["cpc"]
        if term.requires_grad:
            term.backward()
    return {f"gen.{n}": (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
            for n, p in gen.named_parameters()}


def cpc_gate(torch, ckpt: Path) -> None:
    """``gan_gate`` with the CPC term, full width f32, cuDNN deterministic, kernels
    against the plain versions: B, one whole GAN micro-batch (B=2 x 8192; the losses,
    ``cpc`` among them, within ``TOL_F32_REL``, every gradient within ``TOL_GAN_GRAD``,
    the kinks pinned); C, the generator's gradients of the ``cpc`` term alone within
    ``TOL_GAN_GRAD``. A planted fault, the fake branch detached, must be rejected."""
    from speechflow_torch.models.vocoder import Vocos, VocosParams
    from speechflow_torch.models.vocoder.criterion import (
        vocoder_disc_criterion,
        vocoder_gen_criterion,
    )
    from speechflow_torch.models.vocoder.discriminators import VocoderDiscriminator
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.utils.init import filter_kwargs

    model_cfg, _ = TV.configs(TRAIN_PRESET)
    params = VocosParams.create(model_cfg["model"])
    kw = dict(sample_rate=params.sample_rate, n_mels=params.n_mels, device="cuda",
              **filter_kwargs(vocoder_gen_criterion, dict(model_cfg["loss"],
                                                          cpc_ckpt=str(ckpt))))
    torch.manual_seed(0)
    gen = Vocos(params).to("cuda")
    disc = VocoderDiscriminator(**model_cfg["discriminator"]).to("cuda")
    gen_crit, disc_crit = vocoder_gen_criterion(**kw), vocoder_disc_criterion()
    wav = torch.from_numpy(_seg_waves(2, 8192)).to("cuda")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    pins: dict = {}
    try:
        with plain_versions():
            with pinned_kinks(torch, pins):
                ref = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
            c_ref = cpc_term_grads(torch, gen, disc, gen_crit, wav)
        with pinned_kinks(torch, pins):
            got = gan_grads(torch, gen, disc, gen_crit, disc_crit, wav)
        c_got = cpc_term_grads(torch, gen, disc, gen_crit, wav)
        flips = pins["flips"]
        with planted_cpc_fault():
            bad_crit = vocoder_gen_criterion(**kw)
        with pinned_kinks(torch, pins):
            bad = gan_grads(torch, gen, disc, bad_crit, disc_crit, wav)
        c_bad = cpc_term_grads(torch, gen, disc, bad_crit, wav)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    wb, wc = worst_relative(ref[1], got[1]), worst_relative(c_ref, c_got)
    print(f"[vocoder_cpc] f32 GAN micro-batch B2 x 8192 with the CPC loss, cuDNN "
          f"deterministic; losses " + ", ".join(f"{k} {v:.6g}" for k, v in got[0].items())
          + f". B (the micro-batch): {len(ref[1])} gradients, worst relative {wb[0]:.3g} "
          f"({wb[1]}; tol {TOL_GAN_GRAD:g}; {flips} pinned kink elements crossed 0). C (the "
          f"cpc term alone): {len(c_ref)} generator gradients, worst relative {wc[0]:.3g} "
          f"({wc[1]})", flush=True)
    check("gen/cpc" in ref[0] and ref[0]["gen/cpc"] > 0, "vocoder_cpc: no cpc loss")
    fails = gan_disagreement(ref, got, TOL_GAN_GRAD)
    check(not fails, "vocoder_cpc f32 B: kernels disagree with plain: " + "; ".join(fails[:5]))
    check(wc[0] <= TOL_GAN_GRAD, f"vocoder_cpc f32 C: the cpc term's gradients disagree: {wc}")
    fb, fc = gan_disagreement(ref, bad, TOL_GAN_GRAD), worst_relative(c_ref, c_bad)
    print(f"[vocoder_cpc] planted fault (the fake branch detached): B rejects with {len(fb)} "
          f"disagreement(s) {fb[:2]}; C worst relative {fc[0]:.3g} ({fc[1]})", flush=True)
    check(fc[0] > TOL_GAN_GRAD, "the CPC gate passes a detached fake branch")
    del gen, disc, ref, got, bad, c_ref, c_got, c_bad
    torch.cuda.empty_cache()


def phase_vocoder_cpc(torch, gpu_line: str) -> dict:
    """GAN training of the flagship vocoder with the CPC perceptual loss through the
    port's entry point, then ``Denoiser`` over the served vocoder."""
    import tempfile

    import numpy as np

    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.models.vocoder import criterion as C
    from speechflow_torch.models.vocoder.denoiser import Denoiser
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.saver import ExperimentSaver

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = cpc_checkpoint(torch)
    cpc_gate(torch, ckpt)

    model_cfg, data_cfg = TV.configs(TRAIN_PRESET)
    data_cfg["dirs"]["data_root"] = str(SEGS)
    model_cfg["loss"]["cpc_ckpt"] = str(ckpt)
    model_cfg["trainer"]["max_steps"] = CPC_MICRO_BATCHES
    made, real_make = [], C.make_cpc_perceptual_loss

    def recorded(*args, **kwargs):
        made.append(real_make(*args, **kwargs))
        return made[-1]

    st = {"launches": [], "losses": [], "times": [], "cpc": None}

    def callback(trainer, last):
        torch.cuda.synchronize()
        st["times"].append(time.perf_counter())
        counts, vjp_counts = read_counts(), read_vjp_counts()
        reset_counts()
        st["launches"].append(counts)
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        i = trainer.global_step
        check(all(np.isfinite(v) for v in vals.values()) and vals.get("gen/cpc", 0.0) > 0,
              f"vocoder_cpc: losses at micro-batch {i}: {vals}")
        check(counts == TRAIN_LAUNCHES and vjp_counts == TRAIN_VJP_LAUNCHES,
              f"vocoder_cpc: launches at micro-batch {i}: {counts}, {vjp_counts} != "
              f"{TRAIN_LAUNCHES}, {TRAIN_VJP_LAUNCHES}")
        cpc = made[0].model
        check(all(torch.equal(p, q) for p, q in zip(cpc.parameters(), st["cpc"]))
              and all(p.grad is None for p in cpc.parameters()),
              f"vocoder_cpc: the CPC's weights changed at micro-batch {i}")

    with tempfile.TemporaryDirectory() as tmp:
        saver = experiment_saver(model_cfg, data_cfg, tmp)
        C.make_cpc_perceptual_loss = recorded
        try:
            from speechflow_torch.models.ssl import CPCModel, CPCParams
            from speechflow_torch.utils.state_io import load_module

            st["cpc"] = [p.detach().clone() for p in
                         load_module(CPCModel, CPCParams, ckpt, device="cuda")[0].parameters()]
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            expr = TV.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
            t_fit = time.perf_counter() - t0
        finally:
            C.make_cpc_perceptual_loss = real_make
        peak = torch.cuda.max_memory_allocated()
        check(len(made) == 1 and len(st["losses"]) == CPC_MICRO_BATCHES,
              f"vocoder_cpc: {len(made)} CPC losses built, {len(st['losses'])} micro-batches")
        ends = [t0] + st["times"]
        step_ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
        for i, (dt, vals) in enumerate(zip(step_ms, st["losses"])):
            print(f"[vocoder_cpc] micro-batch {i + 1}: {dt:.1f} ms, gen/total "
                  f"{vals['gen/total']:.4f}, gen/cpc {vals['gen/cpc']:.4f}", flush=True)
        ms = float(np.median(step_ms[1:]))
        print(f"[vocoder_cpc] {CPC_MICRO_BATCHES} micro-batches of configs/vocoder_bigvgan.yml "
              f"(B32, bf16 autocast, the CPC in f32) with loss.cpc_ckpt in {t_fit:.1f} s with "
              f"set-up, {ms:.1f} ms a micro-batch (median of 2..{CPC_MICRO_BATCHES}), peak "
              f"device memory {peak / 2**30:.2f} GiB ({gpu_line})", flush=True)
        launches = {k: sum(c[k] for c in st["launches"]) for k in TRAIN_LAUNCHES}

        # Denoiser over the served vocoder (the checkpoint through the interface: folded)
        last_ckpt = ExperimentSaver.get_last_checkpoint(expr)
        vi = VocoderEvaluationInterface.from_checkpoint(*ExperimentSaver.load_checkpoint(
            last_ckpt), device="cuda")
        wav = _seg_waves(1, 64 * HOP * 4, offset=0)[0]
        outs = []
        for mode in (contextlib.nullcontext(), plain_versions()):
            with mode:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                den = Denoiser(vi.model, n_mels=vi.model.params.n_mels)
                audio = vi.resynthesize(AudioChunk(data=wav, sr=SR)).data
                with torch.inference_mode():
                    clean = den(torch.from_numpy(audio).to("cuda")).float().cpu().numpy()
                torch.cuda.synchronize()
                outs.append((clean, read_counts(), 1e3 * (time.perf_counter() - t0)))
        (k_out, k_counts, k_ms), (p_out, _, p_ms) = outs
        err = float(np.abs(k_out - p_out).max())
        lim = TOL_F32_REL * float(np.abs(p_out).max())
        want = {k: 2 * HEAD_LAUNCHES[k] for k in HEAD_LAUNCHES}
        print(f"[vocoder_cpc] Denoiser over the served (folded) vocoder: bias + resynthesize "
              f"{len(wav) / SR:.2f} s + denoise in {k_ms:.1f} ms (plain {p_ms:.1f} ms), "
              f"launches {k_counts}, max_abs_err {err:.3g} against the plain versions (tol "
              f"{lim:.3g})", flush=True)
        check(all(k_counts[k] == want[k] for k in want),
              f"vocoder_cpc: Denoiser launches {k_counts} != {want}")
        check(k_out.shape == p_out.shape and bool(np.isfinite(k_out).all()) and err <= lim,
              "vocoder_cpc: the Denoiser through the kernels disagrees with the plain versions")
        for k in launches:
            launches[k] += k_counts[k]
        del vi
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[vocoder_cpc] phase wall time {phase_s:.1f} s", flush=True)
    return {"launches": launches, "ms": ms, "peak": peak, "phase_s": phase_s}


# -- phase 25: the data-preparation chain -----------------------------------------------

# tests/test_signal1d.py's contour handlers, put before aggregate_pitch
CONTOUR_HANDLERS = {
    "signal_enhancement": {"attributes": "pitch", "interpolate_zeros": True, "smooth": True},
    "average_by_time": {"attributes": ["pitch", "energy", "rate"], "use_quantile": True},
    "normalize": {"attributes": ["pitch", "energy"], "normalize_by": "speaker"},
}
# recomputed from the cache in training: normalize now has the dump's ranges.json, and
# the token aggregates follow the normalised contours
UPDATE_HANDLERS = ["normalize", "aggregate_pitch", "aggregate_energy"]
DATA_PREP_PROSODY_STEPS = 4
DATA_PREP_TTS_STEPS = 2
DATA_PREP_VOC_MICRO_BATCHES = 4
# the waveform augmentations of the vocoder recipe's pipe (after random_chunk), seeded
VOC_AUGMENTATIONS = {
    "aug_gain": {"p": 1.0, "seed": 11},
    "aug_colored_noise": {"p": 1.0, "color": "pink", "seed": 12},
    "aug_clipping": {"p": 1.0, "seed": 13},
    "aug_room_impulse_response": {"p": 1.0, "seed": 14},
}
# every handler new in this slice that the TTS data feeds, in pipe order around the
# config's own (data_pipeline_check): waveform augmentations after load_audio, the
# spectral and LPC features after magnitude, mel augmentations after normalize_mel, the
# contour handlers after pitch, the token- and frame-level ones after calc_durations
CHECK_AFTER = {
    "load_audio": [
        ("resample_audio", {"sample_rate": 24000}), ("dither_audio", {"seed": 1}),
        ("preemphasis_audio", {"coeff": 0.5}), ("loudness_normalize", {"target_dbfs": -23.0}),
        ("mu_law_encode_audio", {}), ("aug_gain", {"p": 1.0, "seed": 2}),
        ("aug_clipping", {"p": 1.0, "seed": 3}), ("aug_colored_noise", {"p": 1.0, "seed": 4}),
        ("aug_pitch_shift", {"p": 1.0, "seed": 5}), ("aug_time_stretch", {"p": 1.0, "seed": 6}),
        ("aug_gain_curve", {"p": 1.0, "seed": 7}), ("aug_frequency_mask", {"p": 1.0, "seed": 8}),
        ("aug_gsm_simulation", {"p": 1.0, "seed": 9}), ("aug_vtlp", {"p": 1.0, "seed": 10}),
        ("aug_room_impulse_response", {"p": 1.0, "seed": 11}),
        ("aug_background_noise", {"p": 1.0, "seed": 12}),
        ("aug_change_rhythm", {"p": 1.0, "mode": "random", "seed": 13}),
        ("aug_monotonic_speech", {"p": 1.0, "seed": 14})],
    "magnitude": [("spectral_flatness", {}), ("spectral_tilt", {}), ("spectral_envelope", {}),
                  ("lpc", {}), ("lpc_from_spectrogram", {}), ("lpc_decompose", {})],
    "normalize_mel": [("store_field", {"key": "mel", "as_key": "clean_mel"}),
                      ("aug_spec_blur", {"p": 1.0, "seed": 15}),
                      ("aug_spec_noise", {"p": 1.0, "seed": 16}),
                      ("aug_spec_augment", {"p": 1.0, "seed": 17})],
    "pitch": [("signal_enhancement", {"attributes": ["pitch", "energy"],
                                      "interpolate_zeros": True, "smooth": True,
                                      "set_zero_in_pauses": True, "max_zero_interval": 20}),
              ("clip", {"attributes": ["pitch"], "min_value": 0.0, "max_value": 800.0}),
              ("timedim_interpolation", {"features": ["pitch", "energy"], "shape_as": "mel"})],
    "add_pauses_from_timestamps": [("apply_fade_inside_pauses", {})],
    "text_to_transcription": [("calc_word_lengths", {}), ("apply_ssml_modifiers", {})],
    "calc_durations": [("average_by_time", {"attributes": ["pitch", "energy", "rate"]}),
                       ("normalize", {"attributes": ["pitch", "energy"],
                                      "normalize_by": "speaker"}),
                       ("calc_invert_durations", {}), ("transcription_by_frames", {})],
    "gate_target": [("pitch_to_wavelet", {"num_bands": 10})],
}


def tts_data_config(data_root, extra_after: tp.Mapping, singletons=None, dump=None) -> dict:
    """``configs/tts_data_24khz.yml`` at its default select over ``data_root``, with the
    handlers of ``extra_after`` ({handler: [(name, params), ...]}) after each handler,
    or, for ``CONTOUR_HANDLERS``, before aggregate_pitch."""
    from speechflow_torch.io.config import Config

    cfg = Config.create_from_file(REPO / "configs" / "tts_data_24khz.yml").to_dict()
    cfg["dirs"]["data_root"] = str(data_root)
    pipe = []
    for name in cfg["preproc"]["pipe"]:
        if name == "aggregate_pitch" and extra_after is CONTOUR_HANDLERS:
            pipe += list(CONTOUR_HANDLERS)
        pipe.append(name)
        pipe += [n for n, _ in (extra_after.get(name) or []) if extra_after is not CONTOUR_HANDLERS]
    cfg["preproc"]["pipe"] = pipe
    params = (CONTOUR_HANDLERS if extra_after is CONTOUR_HANDLERS else
              {n: p for extra in extra_after.values() for n, p in extra})
    cfg["preproc"]["pipe_cfg"].update(json.loads(json.dumps(params)))
    if singletons is not None:
        cfg["singleton_handlers"] = singletons
    if dump is not None:
        cfg["processor"] = {"dump": dump}
    return cfg


def _write_config(cfg: dict, path: Path) -> Path:
    from speechflow_torch.io.config import yaml_dump

    path.write_text(yaml_dump(cfg))
    return path


def prep_dump(tmp: Path, gpu_line: str) -> dict:
    """``dump.main`` twice over the contour config; the per-utterance ms of each pass."""
    import numpy as np

    from speechflow_torch.scripts import dump

    cfg_path = _write_config(tts_data_config(tmp / "SEGS", CONTOUR_HANDLERS),
                             tmp / "tts_data_contours.yml")
    argv = ["-cd", str(cfg_path), "--dump_path", str(tmp / "dump")]
    t0 = time.perf_counter()
    first = dump.main(argv)
    t1 = time.perf_counter()
    cached = dump.main(argv)
    t2 = time.perf_counter()
    n = sum(first["subsets"].values())
    check(n == 50 and sum(cached["subsets"].values()) == n,
          f"data_prep: dumped {first['subsets']} then {cached['subsets']} of SEGS's 50")
    check(cached["cache_misses"] == 0 and cached["cache_hits"] == first["cache_misses"],
          f"data_prep: the cached pass hit {cached['cache_hits']} and missed "
          f"{cached['cache_misses']} of {first['cache_misses']}")
    ranges = json.loads((tmp / "dump" / "ranges.json").read_text())
    cents = np.load(tmp / "dump" / "prosody_centroids.npy")
    check(len(ranges) >= 2 and all({"pitch", "energy"} <= set(r) for r in ranges.values()),
          f"data_prep: ranges.json {ranges}")
    check(cents.shape == (8, 10) and bool(np.isfinite(cents).all()),
          f"data_prep: centroids {cents.shape}")
    for label, rep in (("first", first), ("cached", cached)):
        ms = np.asarray(rep["sample_ms"])
        print(f"[data_prep] dump {label} pass: {len(ms)} utterances, ms each "
              + " ".join(f"{v:.1f}" for v in ms)
              + f"; median {np.median(ms):.1f} ms, total {ms.sum() / 1e3:.2f} s; cache hits "
              f"{rep['cache_hits']}, handler runs {rep['cache_misses']}", flush=True)
    print(f"[data_prep] dump: {t1 - t0:.1f} s then {t2 - t1:.1f} s cached (host, one "
          f"process); ranges.json {len(ranges)} speakers, {first['n_contours']} word "
          f"contours -> {len(cents)} centroids ({gpu_line})", flush=True)
    return {"dump_first_ms": float(np.median(first["sample_ms"])),
            "dump_cached_ms": float(np.median(cached["sample_ms"])), "cfg": cfg_path}


def prep_prosody(torch, tmp: Path, cfg_path: Path, gpu_line: str) -> dict:
    """``prosody_annotation.main`` from the dump, then ``train_prosody`` on those labels."""
    import numpy as np

    from speechflow_torch.io.seg import AudioSeg
    from speechflow_torch.scripts import prosody_annotation
    from speechflow_torch.scripts import train_prosody as TP
    from speechflow_torch.scripts.common import experiment_saver

    n = prosody_annotation.main(["-cd", str(cfg_path), "--dump_path", str(tmp / "dump")])
    words = labelled = 0
    for f in sorted((tmp / "SEGS").rglob("*.TextGridStage3")):
        labels = AudioSeg.load(f).grid["prosody"].labels
        words += len(labels)
        labelled += sum(lab != "undefined" for lab in labels)
    check(n == 50 and labelled > 0, f"data_prep: {n} segs annotated, {labelled} words labelled")
    model_cfg = TP.configs("default")[0]
    model_cfg["trainer"].update(max_steps=DATA_PREP_PROSODY_STEPS, log_every=1,
                                ckpt_every=DATA_PREP_PROSODY_STEPS)
    ends, losses = [], []

    def callback(trainer, last):
        losses.append(float(last["total_loss"]))
        ends.append(time.perf_counter())

    saver = experiment_saver(model_cfg, {"dirs": {"data_root": str(tmp / "SEGS")}},
                             tmp / "prosody")
    before = read_counts()
    TP.train(model_cfg, tmp / "SEGS", saver, device="cuda", callbacks=[callback])
    launches = read_counts()["fused_attention"] - before["fused_attention"]
    check(len(losses) == DATA_PREP_PROSODY_STEPS and bool(np.isfinite(losses).all()),
          f"data_prep: prosody losses {losses}")
    check(launches == PROSODY_LAUNCHES * DATA_PREP_PROSODY_STEPS,
          f"data_prep: {launches} attention launches in {DATA_PREP_PROSODY_STEPS} prosody steps")
    ms = float(np.median(1e3 * np.diff(ends)))
    print(f"[data_prep] prosody_annotation: {n} segs, {labelled} of {words} words labelled "
          f"({labelled / words:.3f}); train_prosody default (256 x 4 x 4, B"
          f"{model_cfg['batch']['size']}) on those labels: {DATA_PREP_PROSODY_STEPS} steps, "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}, {ms:.2f} ms a step (median between "
          f"step ends), {launches} fused attention launches (f32: TF32 route; {gpu_line})",
          flush=True)
    return {"labelled": labelled / words, "prosody_ms": ms}


def prep_tts(torch, tmp: Path, gpu_line: str) -> dict:
    """``train_tts`` at the flagship's width over the normalised, cached pipeline."""
    import statistics

    import numpy as np

    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training.trainer import Trainer

    model_cfg, _ = TT.configs("default")
    check(model_cfg["model"]["encoder_dim"] == 768,
          f"data_prep: tts_model.yml read as {model_cfg['model']}")
    model_cfg["trainer"].update(max_steps=DATA_PREP_TTS_STEPS, ckpt_every=DATA_PREP_TTS_STEPS)
    model_cfg["experiment"]["g2p_steps"] = TTS_G2P_STEPS
    data_cfg = tts_data_config(
        tmp / "SEGS", CONTOUR_HANDLERS,
        singletons={"SpeakerIDSetter": {}, "DatasetStatistics": {}, "PhonemeStatistics": {},
                    "StatisticsRange": {"ranges_file": str(tmp / "dump" / "ranges.json")}},
        dump={"dump_path": str(tmp / "dump"), "full_dump": True,
              "update_handlers": UPDATE_HANDLERS})
    st = {"steps": [], "ends": []}
    real_step = Trainer.training_step

    def step(self, batch):
        st["rows"] = batch.mel.shape[0]
        avg = batch.averages
        check(avg is not None and set(avg) == {"pitch", "energy", "rate"}
              and all(bool(np.isfinite(v).all()) and v.shape == (batch.mel.shape[0],)
                      for v in avg.values()),
              f"data_prep: collated averages {avg}")
        check(float(np.abs(batch.pitch).max()) < 20.0,
              "data_prep: the batch's pitch is not normalised by speaker")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        st["steps"].append(1e3 * (time.perf_counter() - t0))
        return out

    def callback(trainer, last):
        st["ends"].append(time.perf_counter())
        check(all(np.isfinite(float(v)) for v in last.values()), f"data_prep: losses {last}")

    saver = experiment_saver(model_cfg, data_cfg, tmp / "tts")
    Trainer.training_step = step
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        expr = TT.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
    finally:
        Trainer.training_step = real_step
    peak = torch.cuda.max_memory_allocated() / 2**30
    ends = [t0] + st["ends"]
    wall = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
    check(len(st["steps"]) == DATA_PREP_TTS_STEPS, f"data_prep: {len(st['steps'])} tts steps")
    ms, wall_ms = statistics.median(st["steps"][1:]), statistics.median(wall[1:])
    pkl_mb = float(np.mean([f.stat().st_size for f in (tmp / "dump").glob("*.pkl")])) / 2**20
    print(f"[data_prep] train_tts default (768 x 6 x 6, CFM-DiT, f32, B{st['rows']}) over "
          f"the dump's cache with ranges.json: "
          f"{DATA_PREP_TTS_STEPS} steps, {ms:.1f} ms in the step, {wall_ms:.1f} ms between "
          f"steps (medians of 2..{DATA_PREP_TTS_STEPS}; the first {wall[0] / 1e3:.1f} s with "
          f"set-up and G2P), peak device memory {peak:.2f} GiB; averages pitch / energy / "
          f"rate collated and finite; each sample's cache {pkl_mb:.2f} MiB, read and, "
          f"with the recomputed handlers, written again a step ({gpu_line})", flush=True)
    return {"tts_ms": ms, "tts_wall_ms": wall_ms, "tts_peak": peak, "expr": expr}


def prep_eval(torch, tmp: Path, expr, gpu_line: str) -> dict:
    """``eval_tts.main`` on the trained checkpoint with a seeded BigVGAN checkpoint. A
    model trained for a few steps predicts next to no frames, so every token is given
    ``TTS_FORWARD_FRAMES`` (as ``tts_forward_train`` serves its model)."""
    import dataclasses

    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.convert import nnx_from_module
    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.scripts import eval_tts
    from speechflow_torch.training.saver import ExperimentSaver

    _, voc_p = serving.flagship_params()
    vm = seeded_vocoder(torch, voc_p)
    saver = ExperimentSaver(tmp, expr_suffix="vocoder")
    saver.to_save.update({"model_params": dataclasses.asdict(voc_p)})
    voc_ckpt = saver.save(0, nnx_from_module(vm))
    del vm
    argv = ["--tts_ckpt", str(expr), "--vocoder_ckpt", str(voc_ckpt)]
    before = read_counts()
    torch.manual_seed(0)
    t0 = time.perf_counter()
    with injected_frames(torch, TTS_FORWARD_FRAMES):
        written = eval_tts.main(argv + ["--out", str(tmp / "eval")])
    eval_s = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in read_counts().items()}
    n_texts = len(eval_tts.DEFAULT_TEXTS)
    check(counts == {k: n_texts * v for k, v in EXPECTED_LAUNCHES.items()},
          f"data_prep: eval_tts launches {counts} for {n_texts} texts")
    for i in range(n_texts):
        mel = np.load(tmp / "eval" / f"{i}.mel.npy")
        wav = AudioChunk(file_path=tmp / "eval" / f"{i}.wav").load().data
        check(mel.shape[1] == voc_p.n_mels and bool(np.isfinite(mel).all()),
              f"data_prep: mel {i} {mel.shape}")
        check(len(wav) == (mel.shape[0] - 1) * HOP and bool(np.isfinite(wav).all())
              and float(wav.std()) > 1e-4,
              f"data_prep: wav {i}: {len(wav)} samples for {mel.shape[0]} frames, "
              f"std {wav.std():.3g}")
    # kernels against plain on one sentence, f32, the same noise
    sentence = ["--text", eval_tts.DEFAULT_TEXTS[0]]
    outs = {}
    for label, ctx in (("plain", plain_versions()), ("kernels", contextlib.nullcontext())):
        with uncounted(), ctx, injected_frames(torch, TTS_FORWARD_FRAMES):
            torch.manual_seed(0)
            eval_tts.main(argv + sentence + ["--out", str(tmp / label)])
        outs[label] = (np.load(tmp / label / "0.mel.npy"),
                       AudioChunk(file_path=tmp / label / "0.wav").load().data)
    (mel_k, wav_k), (mel_p, wav_p) = outs["kernels"], outs["plain"]
    check(mel_k.shape == mel_p.shape, f"data_prep: frames {mel_k.shape} vs plain {mel_p.shape}")
    mel_err, wav_err = float(np.abs(mel_k - mel_p).max()), float(np.abs(wav_k - wav_p).max())
    mel_lim = TOL_F32_REL * float(np.abs(mel_p).max())
    # the .wav files are 16-bit PCM: add its step (1/32767) to the waveform's limit
    wav_lim = TOL_F32_REL * float(np.abs(wav_p).max()) + 1.0 / 32767
    print(f"[data_prep] eval_tts: {n_texts} texts in {eval_s:.1f} s with the checkpoints' "
          f"load -> {len(written)} files, launches {counts}; one sentence f32 kernels vs "
          f"plain: mel max_abs_err {mel_err:.3g} (tol {mel_lim:.3g}), wav {wav_err:.3g} (tol "
          f"{wav_lim:.3g}, 16-bit files) ({gpu_line})", flush=True)
    check(mel_err <= mel_lim and wav_err <= wav_lim, "data_prep: eval_tts kernels disagree "
                                                     "with plain")
    return {"eval_s": eval_s}


def prep_vocoder(torch, tmp: Path, gpu_line: str) -> dict:
    """The flagship vocoder recipe (bf16) without and with the waveform augmentations.
    SEGS's 45 train files make micro-batches of 32 and 13 chunks in turn, and the first
    of each size also picks cuDNN's algorithms, so the runs are compared on micro-batches
    3 and 4."""
    import numpy as np

    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.training import gan_trainer as GT

    rng = np.random.default_rng(0)
    ir = (rng.standard_normal(SR // 4) * np.exp(-np.arange(SR // 4) / (0.05 * SR)))
    AudioChunk(data=(0.5 * ir / np.abs(ir).max()).astype(np.float32), sr=SR).save(
        tmp / "ir.wav", overwrite=True)
    real_gen_step = GT.GANTrainer._generator_step
    res = {}
    for label, augs in (("plain data", {}), ("augmented", VOC_AUGMENTATIONS)):
        model_cfg, data_cfg = TV.configs("default", data_root=SEGS)
        model_cfg["trainer"].update(max_steps=DATA_PREP_VOC_MICRO_BATCHES,
                                    ckpt_every=DATA_PREP_VOC_MICRO_BATCHES)
        pipe = data_cfg["preproc"]["pipe"]
        i = pipe.index("random_chunk") + 1
        pipe[i:i] = list(augs)
        data_cfg["preproc"]["pipe_cfg"].update(json.loads(json.dumps(augs)))
        if augs:
            data_cfg["preproc"]["pipe_cfg"]["aug_room_impulse_response"]["ir_paths"] = [
                str(tmp / "ir.wav")]
        ends, sizes = [], []

        def gen_step(self, inputs, targets, step):
            sizes.append(int(inputs["waveform"].shape[0]))
            return real_gen_step(self, inputs, targets, step)

        saver = experiment_saver(model_cfg, data_cfg, tmp / f"voc_{len(augs)}")
        before, vjp_before = read_counts(), read_vjp_counts()
        GT.GANTrainer._generator_step = gen_step
        try:
            t0 = time.perf_counter()
            TV.train(model_cfg, data_cfg, saver, device="cuda",
                     callbacks=[lambda trainer, last: ends.append(time.perf_counter())])
        finally:
            GT.GANTrainer._generator_step = real_gen_step
        counts = {k: v - before[k] for k, v in read_counts().items()}
        vjp_counts = {k: v - vjp_before[k] for k, v in read_vjp_counts().items()}
        check(counts == {k: DATA_PREP_VOC_MICRO_BATCHES * v for k, v in TRAIN_LAUNCHES.items()}
              and vjp_counts == {k: DATA_PREP_VOC_MICRO_BATCHES * v
                                 for k, v in TRAIN_VJP_LAUNCHES.items()},
              f"data_prep: vocoder launches {counts}, VJP launches {vjp_counts}")
        wall = [1e3 * (b - a) for a, b in zip([t0] + ends[:-1], ends)]
        res[label] = [(b, ms) for b, ms in zip(sizes[2:], wall[2:])]
        print(f"[data_prep] vocoder_bigvgan.yml default (bf16) {label} "
              f"({', '.join(augs) or 'no augmentation'}): micro-batches of "
              + ", ".join(f"B{b} {ms:.1f} ms" for b, ms in zip(sizes, wall))
              + f" (between micro-batches; the first with set-up), launches {counts} "
              f"({gpu_line})", flush=True)
    return {"voc_ms": res}


def prep_loader(tmp: Path, gpu_line: str) -> dict:
    """The data server, a worker pool and a loader built from a config path, as JAX's
    ``init_data_loader(config_path=..., value_select=...)`` builds them:
    ``configs/tts_data_24khz.yml`` (its selectors kept) over the SEGS copy at ``debug``;
    two batches against the same pipeline's batches drawn in this process."""
    import re

    import numpy as np

    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.server import get_dataset_iterator, init_data_loader

    text = (REPO / "configs" / "tts_data_24khz.yml").read_text()
    path = tmp / "tts_data_selectors.yml"
    path.write_text(re.sub(r"(?m)^(\s+data_root:).*$", rf"\1 {tmp / 'SEGS'}", text))
    t0 = time.perf_counter()
    bundle = init_data_loader(config_path=path, value_select=["debug"], subsets=["train"],
                              batch_size=2, n_workers=2, prefetch_factor=2)
    try:
        got = [bundle["train"].next_item(timeout=120) for _ in range(2)]
    finally:
        bundle.shutdown()
    t_loader = time.perf_counter() - t0
    pipeline = DataPipeline.init_from_config(path, value_select=["debug"]).init_components()
    it = get_dataset_iterator(pipeline, "train", 2)
    want = [next(it) for _ in range(2)]
    for g, w in zip(got, want):
        check(g.keys == w.keys and np.array_equal(g.collated.mel, w.collated.mel),
              f"data_prep: the config-path loader's batch {g.keys} != {w.keys}")
    print(f"[data_prep] init_data_loader(config_path=tts_data_24khz.yml, value_select="
          f"['debug']): 2 workers, 2 batches of {[g.size for g in got]} equal to the "
          f"in-process pipeline's, {t_loader:.1f} s with start and shutdown ({gpu_line})",
          flush=True)
    return {"loader_s": t_loader}


def prep_check(tmp: Path, gpu_line: str) -> dict:
    """``data_pipeline_check.main`` over the TTS config with every new handler."""
    from speechflow_torch.scripts import data_pipeline_check

    cfg = tts_data_config(tmp / "SEGS", CHECK_AFTER)
    cfg["preproc"]["pipe_cfg"]["aug_room_impulse_response"]["ir_paths"] = [str(tmp / "ir.wav")]
    cfg["singleton_handlers"] = {"SpeakerIDSetter": {}, "DatasetStatistics": {},
                                 "PhonemeStatistics": {},
                                 "StatisticsRange": {"ranges_file": str(tmp / "dump" /
                                                                        "ranges.json")}}
    lines = data_pipeline_check.main(["-cd", str(_write_config(cfg, tmp / "check.yml")),
                                      "--n_batches", "1", "--profile"])
    check("[train] handler IO contracts: OK" in lines and "[test] handler IO contracts: OK"
          in lines, "data_prep: data_pipeline_check's contracts")
    check(all("size=2" in line for line in lines if " batch " in line),
          "data_prep: data_pipeline_check dropped samples")
    head = next(i for i, line in enumerate(lines) if line.startswith("handler host ms"))
    timed = {line.split()[0] for line in lines[head + 1:]}
    new = {n for extra in CHECK_AFTER.values() for n, _ in extra}
    check(new <= timed and len(new) == 39, f"data_prep: handlers not run: {new - timed}")
    print(f"[data_prep] data_pipeline_check: {len(cfg['preproc']['pipe'])} handlers "
          f"({len(new)} new), host ms a sample above ({gpu_line})", flush=True)
    return {}


def prep_ogg() -> dict:
    """The Ogg fixtures through the port's readers, where ctypes finds the libraries."""
    from speechflow_torch.io import codecs
    from speechflow_torch.io.audio import AudioChunk

    found = codecs.available()
    print("[data_prep] ogg libraries: " + ", ".join(f"{k} {'found' if v else 'absent'}"
                                                     for k, v in found.items()), flush=True)
    data = REPO / "tests" / "data"
    meta = dict(line.split("=", 1) for line in (data / "fixture_meta.txt").read_text()
                .splitlines() if "=" in line)
    for name, libs in (("fixture.ogg", ("libvorbisfile",)), ("fixture.opus", ("libopus",))):
        if not all(found[lib] for lib in libs):
            print(f"[data_prep] {name}: not read ({'/'.join(libs)} absent)", flush=True)
            continue
        a = AudioChunk(file_path=data / name).load(sr=int(meta["sr"]))
        check(abs(a.duration - float(meta["seconds"])) < 0.05 and a.sr == int(meta["sr"])
              and float(abs(a.data).max()) > 0.01, f"data_prep: {name} read as {a.duration} s")
        print(f"[data_prep] {name}: {a.duration:.3f} s at {a.sr} Hz (meta {meta['seconds']} s)",
              flush=True)
    return {"ogg": found}


def phase_data_prep(torch, gpu_line: str) -> dict:
    """The data-preparation chain on a copy of SEGS: dump (twice), prosody annotation and
    ``train_prosody``, ``train_tts`` over the normalised cached pipeline, ``eval_tts``,
    the augmented vocoder recipe, ``data_pipeline_check`` and the Ogg fixtures."""
    import tempfile

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="data_prep_", dir=workdir()))
    shutil.copytree(SEGS, tmp / "SEGS")
    reset_counts()
    res = prep_dump(tmp, gpu_line)
    res.update(prep_loader(tmp, gpu_line))
    res.update(prep_prosody(torch, tmp, res.pop("cfg"), gpu_line))
    res.update(prep_tts(torch, tmp, gpu_line))
    torch.cuda.empty_cache()
    res.update(prep_eval(torch, tmp, res.pop("expr"), gpu_line))
    torch.cuda.empty_cache()
    res.update(prep_vocoder(torch, tmp, gpu_line))
    torch.cuda.empty_cache()
    res.update(prep_check(tmp, gpu_line))
    res.update(prep_ogg())
    res["launches"] = read_counts()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[data_prep] phase wall time {res['phase_s']:.1f} s; launches {res['launches']}",
          flush=True)
    return res


# -- phase 25: the annotator's 5-step runner, the tone-corpus recipe, MNIST -----------

SRC = REPO / "tests" / "data" / "SRC"
LJSPEECH = SRC / "EN" / "OPENSOURCE_VOICES" / "001_LJSpeech" / "LJSpeech-1.1"
ANNOTATOR_STEPS = 2  # the cut: 2 of aligner_model.yml's 200,000 steps a stage
GOLOS_DBFS = -30.0
# tests/test_annotator_two_stage.py: 8 utterances of 2-3 words of 0.12 s tones a character,
# about half with a 0.35 s silence after a known word; the debug aligner, 400 steps a stage
TONE_FREQS = {c: 250.0 + 150.0 * i for i, c in enumerate("abcdefgh")}
TONE_WORDS = ["abc", "de", "fgh", "cad", "beg", "fa"]
TONE_STEPS = 100  # the cut (of 400): the gates below pass at 100 steps on the card
MNIST_STEPS, MNIST_BATCH = 200, 64


@contextlib.contextmanager
def timed_calls(torch, owner, name: str, sink: list):
    """Each call of ``owner.name`` timed between synchronisations: (ms, args, result)."""
    raw, real = owner.__dict__[name], getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append((1e3 * (time.perf_counter() - t0), args, out))
        return out

    setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
    try:
        yield sink
    finally:
        setattr(owner, name, raw)


@contextlib.contextmanager
def runner_timers(torch):
    """The calls an annotator run spends its time in, each timed (``timed_calls``):
    label -> the list of (ms, args, result)."""
    from speechflow_torch.annotator.align import Aligner
    from speechflow_torch.data.core.components import AudioLoader, DataPipeline
    from speechflow_torch.training.trainer import Trainer

    targets = {"pipeline": (DataPipeline, "from_config"), "data": (AudioLoader, "next_batch"),
               "step": (Trainer, "training_step"), "save": (Trainer, "save_checkpoint"),
               "loader close": (AudioLoader, "close"), "aligner load": (Aligner, "__init__"),
               "align": (Aligner, "run")}
    sinks = {label: [] for label in targets}
    with contextlib.ExitStack() as stack:
        for label, (owner, name) in targets.items():
            stack.enter_context(timed_calls(torch, owner, name, sinks[label]))
        yield sinks


def time_split(sinks: dict, wall_s: float) -> str:
    """Seconds in each timed call of ``runner_timers`` (the first training step and the
    first data wait apart) and the rest of ``wall_s``."""
    parts = {k: sum(c[0] for c in v) / 1e3 for k, v in sinks.items()}
    for k in ("step", "data"):
        if sinks[k]:
            parts[f"first {k}"] = sinks[k][0][0] / 1e3
            parts[k] -= parts[f"first {k}"]
    rest = wall_s - sum(v for k, v in parts.items())
    return ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f", other {rest:.1f} s"


def _dbfs(wav) -> float:
    import numpy as np

    return float(20 * np.log10(np.sqrt(np.mean(np.square(wav, dtype=np.float64)))))


def annot_prepare(tmp: Path, gpu_line: str) -> dict:
    """``prepare_datasets``: the LJSpeech layout of the SRC copy (``metadata.csv`` ->
    ``.txt``), a golos layout of 4 SRC wavs (loudness to ``GOLOS_DBFS``), and Ogg
    conversion (hifi_tts) where the machine has the codec libraries."""
    import json

    import numpy as np

    from speechflow_torch.annotator import prepare_datasets as PD
    from speechflow_torch.io import codecs
    from speechflow_torch.io.audio import AudioChunk

    t0 = time.perf_counter()
    lj = tmp / "SRC" / LJSPEECH.relative_to(SRC)
    rows = [r.split("|")[0] for r in (lj / "metadata.csv").read_text().splitlines() if r]
    expect = sum((lj / "wavs" / f"{r}.wav").exists() for r in rows)
    n_lj = PD.main(["ljspeech", "-d", str(lj)])
    check(n_lj == expect > 0 and all((lj / "wavs" / f"{r}.txt").exists() for r in rows),
          f"prepare ljspeech: {n_lj} of {expect}")
    golos = tmp / "golos" / "crowd"
    golos.mkdir(parents=True)
    wavs = sorted(SRC.rglob("*.wav"))[::12][:4]
    manifest = []
    for i, w in enumerate(wavs):
        shutil.copy(w, golos / f"{i}.wav")
        manifest.append(json.dumps({"audio_filepath": f"{i}.wav", "text": f"utterance {i}"}))
    (golos / "manifest.jsonl").write_text("\n".join(manifest))
    before = [_dbfs(AudioChunk(file_path=w).load().waveform) for w in wavs]
    n_golos = PD.main(["golos", "-d", str(tmp / "golos")])
    after = [_dbfs(AudioChunk(file_path=golos / f"{i}.wav").load().waveform)
             for i in range(len(wavs))]
    check(n_golos == len(wavs) and all(abs(a - GOLOS_DBFS) < 0.1 for a in after),
          f"prepare golos: {n_golos} files, dBFS {after}")
    found = codecs.available()
    if all(found[lib] for lib in ("libogg", "libvorbis", "libvorbisenc", "libvorbisfile")):
        hifi = tmp / "hifi"
        AudioChunk(file_path=wavs[0]).load().save(hifi / "audio" / "0.ogg")
        (hifi / "manifest.json").write_text(json.dumps(
            {"audio_filepath": "audio/0.ogg", "text_normalized": "Zero."}))
        check(PD.prepare_hifi_tts(hifi) == 1 and (hifi / "audio" / "0.wav").exists(),
              "prepare hifi_tts: the Ogg file was not converted")
        ogg = "hifi_tts: the Ogg/Vorbis file converted to wav"
    else:
        ogg = ("hifi_tts's Ogg conversion not run: "
               + ", ".join(k for k, v in found.items() if not v) + " absent on this machine")
    print(f"[annotator] prepare_datasets: ljspeech {n_lj} .txt of {len(rows)} metadata rows; "
          f"golos {n_golos} wavs from dBFS {np.round(before, 2).tolist()} to "
          f"{np.round(after, 3).tolist()} (target {GOLOS_DBFS}); {ogg}; "
          f"{time.perf_counter() - t0:.1f} s ({gpu_line})", flush=True)
    return {"ljspeech_txt": n_lj, "golos": n_golos, "ogg": ogg}


def annot_runner(torch, tmp: Path, gpu_line: str) -> dict:
    """``runner.main -vs default --max_steps ANNOTATOR_STEPS`` over the SRC copy: steps 0
    and 1 (timed on the host), then 2, 3 and 4 on the card with each training step and
    each ``Aligner.run`` timed; every grid read back; the stage-3 grids re-aligned
    through the kernels and the plain versions."""
    import numpy as np

    from speechflow_torch.annotator import runner
    from speechflow_torch.annotator.align import Aligner
    from speechflow_torch.io.config import yaml_dump, yaml_load
    from speechflow_torch.io.seg import AudioSeg
    from speechflow_torch.training.saver import ExperimentSaver

    # aligner_model.yml with its experiments in tmp; beside it stage 2's data config reads
    # the grids of a 6-step stage 1 with the config's own debug phoneme limit (2.0 s): the
    # default 0.3 s would drop every one of them
    cfg_dir = tmp / "configs"
    cfg_dir.mkdir()
    model = yaml_load((REPO / "configs" / "aligner_model.yml").read_text())
    model["experiment"]["base_dir"] = str(tmp / "exp")
    (cfg_dir / "aligner_model.yml").write_text(yaml_dump(model))
    data2 = yaml_load((REPO / ALIGNER_DATA2).read_text())
    data2["parser"]["max_phoneme_length"] = data2["parser"]["max_phoneme_length"]["debug"]
    (cfg_dir / Path(ALIGNER_DATA2).name).write_text(yaml_dump(data2))
    src, out = tmp / "SRC", tmp / "annotated"
    common = ["-d", str(src), "-o", str(out), "-vs", "default", "--aligner_config",
              str(cfg_dir / "aligner_model.yml")]

    t0 = time.perf_counter()
    rep = runner.main(common + ["--steps", "0", "1"])
    ms_seg = 1e3 * (time.perf_counter() - t0) / max(rep["segs"], 1)
    n_wavs = len(list(src.rglob("*.wav")))
    check(rep["transcribed"] == n_wavs and rep["segs"] >= n_wavs,
          f"annotator: steps 0-1 gave {rep}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts()
    t0 = time.perf_counter()
    with runner_timers(torch) as sinks:
        rep2 = runner.main(common + ["--steps", "2", "3", "4", "--max_steps",
                                     str(ANNOTATOR_STEPS)])
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps, aligns = sinks["step"], sinks["align"]
    rep.update(rep2)
    check(len(steps) == 2 * ANNOTATOR_STEPS and len(aligns) == 3,
          f"annotator: {len(steps)} training steps, {len(aligns)} alignments")
    exps = sorted((tmp / "exp").iterdir())
    ckpt2 = ExperimentSaver.get_last_checkpoint(exps[-1])
    m = ExperimentSaver.load_payload(ckpt2)["model_params"]
    check(m["encoder_dim"] == 192 and m["encoder_layers"] == 4 and m["encoder_heads"] == 2
          and m["n_flows"] == 6, f"annotator: the aligner trained as {m}")
    check(yaml_load((exps[-1] / "model.yml").read_text())["warmstart"]["ckpt"]
          == str(ExperimentSaver.get_last_checkpoint(exps[0])),
          "annotator: stage 2 did not start from stage 1's checkpoint")
    grids = {}
    for stage in (1, 2, 3):
        files = sorted((out / "SEGS").rglob(f"*.TextGridStage{stage}"))
        for f in files:
            seg = AudioSeg.load(f)
            times = np.asarray([iv[:2] for iv in seg.phonemes()])
            check(len(times) > 0 and bool((np.diff(times[:, 0]) >= 0).all())
                  and times[-1, 1] <= seg.duration + 1e-6, f"annotator: {f.name} reads back wrong")
        grids[stage] = files
    check([len(grids[s]) for s in (1, 2, 3)] == [rep["stage1_aligned"], rep["stage2_aligned"],
                                                 rep["stage3"]] and grids[3],
          f"annotator: grids {[len(g) for g in grids.values()]} against the report {rep}")
    n_spk = sum(v["n"] for v in rep["speakers"].values())
    check(n_spk == rep["stage3"], f"annotator: speaker stats count {n_spk}")
    ms_step = [float(np.median([s[0] for s in steps[k * ANNOTATOR_STEPS:][1:ANNOTATOR_STEPS]]))
               for k in (0, 1)]
    ms_utt = [a[0] / max(len(a[2]), 1) for a in aligns]
    print(f"[annotator] runner over the SRC copy ({n_wavs} wavs), aligner_model.yml default "
          f"(192 wide, 4 layers of 2 heads of 96, 6 flows), {ANNOTATOR_STEPS} steps a stage, f32 "
          f"(TF32 off): sidecars {rep['transcribed']}, segs {rep['segs']}, stage-1/2/3 grids "
          f"{rep['stage1_aligned']}/{rep['stage2_aligned']}/{rep['stage3']}, speakers "
          f"{len(rep['speakers'])} ({n_spk} utterances, "
          f"{sum(v['duration'] for v in rep['speakers'].values()):.1f} s); {ms_seg:.1f} ms a seg "
          f"(steps 0-1, host); ms a training step (median of 2..{ANNOTATOR_STEPS}) stage 1 "
          f"{ms_step[0]:.1f}, stage 2 {ms_step[1]:.1f}; ms an aligned utterance stage 1/2/3 "
          + "/".join(f"{v:.1f}" for v in ms_utt)
          + f"; steps 2-4 {wall:.1f} s ({time_split(sinks, wall)}); attention launches "
          f"{launches['fused_attention']} ({gpu_line})", flush=True)
    al = Aligner(ckpt2, device="cuda")
    attn, _ = aligner_kernels_vs_plain(torch, "annotator", "a batch of stage-3 grids", al,
                                       grids[3], gpu_line)
    del al
    torch.cuda.empty_cache()
    return {"report": rep, "ms_seg": ms_seg, "ms_step": ms_step, "ms_utt": ms_utt,
            "launches": launches, "attn": attn}


def _tone(freq: float, dur: float, rng):
    import numpy as np

    t = np.arange(int(dur * SR)) / SR
    sig = np.sin(2 * np.pi * freq * t) + 0.3 * np.sin(2 * np.pi * 2 * freq * t)
    env = np.minimum(1.0, np.minimum(np.arange(len(t)), np.arange(len(t))[::-1]) / (0.01 * SR))
    return (0.3 * sig * env + 0.003 * rng.standard_normal(len(t))).astype(np.float32)


def tone_corpus(root: Path) -> dict:
    """tests/test_annotator_two_stage.py's corpus: ``<u>.wav`` and ``<u>.TextGrid`` (a
    ``text`` tier) for 8 utterances; returns the known silences, by utterance."""
    import numpy as np

    from speechflow_torch.io.audio import AudioChunk
    from speechflow_torch.io.seg import AudioSeg, TextGrid, Tier

    rng = np.random.default_rng(7)
    gaps = {}
    for u in range(8):
        n_words = int(rng.integers(2, 4))
        words = [TONE_WORDS[int(rng.integers(len(TONE_WORDS)))] for _ in range(n_words)]
        gap_after = int(rng.integers(0, n_words - 1)) if u % 2 == 0 else None
        pieces, word_ts, cur = [np.zeros(int(0.2 * SR), np.float32)], [], 0.2
        for w_i, w in enumerate(words):
            wb = cur
            for ch in w:
                pieces.append(_tone(TONE_FREQS[ch], 0.12, rng))
                cur += 0.12
            word_ts.append((wb, cur, w))
            if w_i == gap_after:
                pieces.append(np.zeros(int(0.35 * SR), np.float32))
                gaps[u] = (cur, cur + 0.35)
                cur += 0.35
        pieces.append(np.zeros(int(0.2 * SR), np.float32))
        cur += 0.2
        AudioChunk(data=np.concatenate(pieces), sr=SR).save(root / f"{u}.wav")
        grid = TextGrid(0.0, cur)
        grid.add(Tier("text", word_ts))
        seg = AudioSeg(AudioChunk(file_path=root / f"{u}.wav"), grid)
        seg.meta.update(speaker_name="tone", lang="EN")
        seg.save(root / f"{u}.TextGrid")
    return gaps


def annot_tone(torch, tmp: Path, gpu_line: str) -> dict:
    """Runner step 2 on the tone corpus at the debug width, ``TONE_STEPS`` steps a stage
    (lr 0.002, 2 data workers), held to tests/test_annotator_two_stage.py's assertions: the stages'
    grids written; stage 2 trained on stage 1's output; stage 2's grids differ, with
    fewer pauses; stage 2's long pauses on the known silences, and quiet."""
    import numpy as np

    from speechflow_torch.annotator import runner
    from speechflow_torch.io.config import Config, yaml_dump
    from speechflow_torch.io.seg import AudioSeg

    root, out = tmp / "tone", tmp / "tone_out"
    root.mkdir()
    out.mkdir()
    gaps = tone_corpus(root)
    cfg = Config.create_from_file(REPO / "configs" / "aligner_model.yml", ["debug"]).to_dict()
    cfg["experiment"]["base_dir"] = str(out / "experiments")
    cfg["trainer"].update(max_steps=TONE_STEPS, ckpt_every=TONE_STEPS)
    cfg["optimizer"]["lr"] = 0.002
    # one worker keeps a debug step waiting ~19 ms for its data; the batches are the
    # sampler's, drawn here, whatever the workers
    cfg["data_loaders"]["n_workers"] = 2
    (out / "aligner_model.yml").write_text(yaml_dump(cfg))
    losses = []
    t0 = time.perf_counter()
    with runner_timers(torch) as sinks:
        runner.main(["-d", str(root), "-o", str(out), "--steps", "2", "--aligner_config",
                     str(out / "aligner_model.yml"), "-vs", "debug",
                     "--max_steps", str(TONE_STEPS)])
    wall = time.perf_counter() - t0
    steps = sinks["step"]
    for k in (0, 1):
        losses.append([float(s[2]["total_loss"])
                       for s in steps[k * TONE_STEPS:(k + 1) * TONE_STEPS]])
    s1, s2 = sorted(root.glob("*.TextGridStage1")), sorted(root.glob("*.TextGridStage2"))
    check(len(s1) >= 6 and len(s2) >= 4, f"tone: {len(s1)} stage-1, {len(s2)} stage-2 grids")
    exps = sorted((out / "experiments").iterdir())
    data2 = (exps[-1] / "data.yml").read_text()
    check(len(exps) >= 2 and ".TextGridStage1" in data2 and "add_pauses_from_timestamps" in data2
          and "add_pauses_from_text" in (exps[0] / "data.yml").read_text(),
          "tone: stage 2 did not train on stage 1's output")
    n_sil1, n_sil2, diff = [], [], 0
    for f2 in s2:
        f1 = f2.with_suffix(".TextGridStage1")
        phs1, phs2 = AudioSeg.load(f1).phonemes(), AudioSeg.load(f2).phonemes()
        if [iv[2] for iv in phs1] != [iv[2] for iv in phs2] or not np.allclose(
                [iv[0] for iv in phs1][:len(phs2)], [iv[0] for iv in phs2][:len(phs1)],
                atol=1e-3):
            diff += 1
        n_sil1.append(sum(1 for iv in phs1 if not iv[2]))
        n_sil2.append(sum(1 for iv in phs2 if not iv[2]))
    hits, total, ratios = 0, 0, []
    for u, (gb, ge) in gaps.items():
        f2 = root / f"{u}.TextGridStage2"
        if not f2.exists():
            continue
        seg = AudioSeg.load(f2)
        wav = np.asarray(seg.audio_chunk.load(sr=SR).waveform, np.float64)
        rms_all = np.sqrt((wav ** 2).mean()) + 1e-9
        sils = [(b, e) for b, e, lab in seg.phonemes() if not lab and e - b >= 0.1]
        total += 1
        hits += any(sb - 0.1 <= 0.5 * (gb + ge) <= se + 0.1 for sb, se in sils)
        ratios += [np.sqrt((wav[int(b * SR):int(e * SR)] ** 2).mean()) / rms_all
                   for b, e in sils if int(e * SR) > int(b * SR)]
    ratio = float(np.mean(ratios)) if ratios else float("nan")
    ms = [float(np.median([s[0] for s in steps[k * TONE_STEPS:(k + 1) * TONE_STEPS][1:]]))
          for k in (0, 1)]
    print(f"[annotator] tone corpus (8 utterances, {len(gaps)} with a known 0.35 s silence), "
          f"debug aligner, {TONE_STEPS} steps a stage: loss stage 1 {losses[0][0]:.4g} -> "
          f"{np.mean(losses[0][-20:]):.4g} (mean of the last 20), stage 2 {losses[1][0]:.4g} -> "
          f"{np.mean(losses[1][-20:]):.4g}; {ms[0]:.1f} / {ms[1]:.1f} ms a step; grids "
          f"{len(s1)} / {len(s2)}; stage 2 differs in {diff}; pauses a grid stage 1 "
          f"{np.mean(n_sil1):.2f}, stage 2 {np.mean(n_sil2):.2f}; known silences hit "
          f"{hits}/{total}; pause energy ratio {ratio:.3f}; {wall:.1f} s "
          f"({time_split(sinks, wall)}) ({gpu_line})", flush=True)
    check(diff >= 1, "tone: the stage-2 grids equal the stage-1 grids")
    check(np.mean(n_sil2) < np.mean(n_sil1), f"tone: pauses {n_sil1} -> {n_sil2}")
    check(total >= 2 and hits / total >= 0.5 and ratio < 0.6,
          f"tone: known silences hit {hits}/{total}, pause energy ratio {ratio}")
    return {"tone_loss": [(ls[0], float(np.mean(ls[-20:]))) for ls in losses],
            "tone_hits": (hits, total), "tone_ratio": ratio, "tone_ms": ms}


def annot_mnist(torch, gpu_line: str) -> dict:
    """The port's MNIST example on the card (``MNIST_STEPS`` steps of ``MNIST_BATCH``, the
    synthetic images), gated as JAX's example is: accuracy above 0.8."""
    from speechflow_torch.examples.mnist import train as M

    t0 = time.perf_counter()
    run = M.main(["--steps", str(MNIST_STEPS), "--batch", str(MNIST_BATCH)])
    first, last = run["first"], run["last"]
    print(f"[annotator] MNIST example: {MNIST_STEPS} steps of B{MNIST_BATCH}: ce "
          f"{first['ce']:.4f} -> {last['ce']:.4f}, accuracy {last['constant_acc']:.3f}; "
          f"{run['ms_step']:.3f} ms a step (median, synchronised); "
          f"{time.perf_counter() - t0:.1f} s ({gpu_line})", flush=True)
    check(next(run["model"].parameters()).is_cuda, "MNIST: the model is not on the card")
    return {"mnist": {"ce": (first["ce"], last["ce"]), "acc": last["constant_acc"],
                      "ms_step": run["ms_step"]}}


def phase_annotator(torch, gpu_line: str) -> dict:
    """The annotator on a copy of ``tests/data/SRC``: corpus preparation, the 5-step
    runner at ``aligner_model.yml``'s default width (its launches are the path's), the
    kernels against the plain versions on its stage-3 grids, the two-stage recipe on
    the tone corpus, and the MNIST example."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="annotator_", dir=workdir()))
    shutil.copytree(SRC, tmp / "SRC")
    res = annot_prepare(tmp, gpu_line)
    res.update(annot_runner(torch, tmp, gpu_line))
    res.update(annot_tone(torch, tmp, gpu_line))
    res.update(annot_mnist(torch, gpu_line))
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[annotator] phase wall time {res['phase_s']:.1f} s; the runner's launches "
          f"{res['launches']}", flush=True)
    return res


# -- phase 27: data-parallel training ------------------------------------------------

DDP_WORLD = 2
DDP_TTS_STEPS = 2  # the cut (was 3): step 1 at lr 0, step 2 moves the weights
DDP_TTS_BATCH = 8  # the cut (was 40, the whole train split): a global batch of 8, 4 a rank
DDP_GAN_MICRO_BATCHES = 8  # one optimizer step at the recipe's grad_accum 8
DDP_GATE_WAVE = (1, 8192)  # each rank's rows and samples of the GAN gate (float64)
# the float64 GAN gate (updates of each tensor's largest, and losses): on an H100 (700 W)
# the ranks read 4.78e-10 (a bias whose gradient sums to ~1e-6 of its terms), the per-rank
# STFT normaliser fault 1.15e-2 and a rank that skips the all-reduce 16; the limit lies between
TOL_DDP_F64 = 1e-6
DDP_TIMEOUT_S = 300  # both ranks joined within this, else the phase fails
DDP_COLLECTIVE_S = 60  # a collective waits no longer (gloo's default: 30 minutes)


def concat_rows(parts: list):
    """The ranks' parts of a collated batch as one (each is padded as the whole batch)."""
    import dataclasses

    import numpy as np

    first = parts[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts) if first.ndim else first
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{f.name: concat_rows([getattr(p, f.name)
                                                                  for p in parts])
                                             for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return {k: concat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(v for p in parts for v in p)
    return first


def ddp_draws(torch, model, rows: slice, shape: tuple):
    """Rows ``rows`` of the CFM's u, z and CFG masks for a global batch of mel ``shape``,
    drawn from one seed on the CPU (every rank and the reference draw alike)."""
    from speechflow_torch.models.tts.decoders import CFMDraws

    full = model.decoder.draw(shape[0], shape, torch.device("cpu"),
                              torch.Generator().manual_seed(0))
    return CFMDraws(*(a[rows].to("cuda") for a in full))


def ddp_gather(torch, obj):
    """Every rank's ``obj`` on rank 0 (pickled through the process group), in rank
    order; None on the other ranks."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def ddp_tts_gate(torch, trainer, batch, rank: int, world: int) -> tp.Optional[dict]:
    """On every rank, before its first step, with the trainer's model given seeded
    random weights (``serving.init_random_`` from a CUDA generator: flax's zero DiT
    modulations would zero the DiT trunk's gradients) and dropout off for the gate: f32 gradients of the step
    with injected draws, averaged over the ranks, and again with the planted fault
    (each rank's own valid-frame count as the loss normaliser). Rank 0 then gathers
    the ranks' batches and ReLU masks and computes one process's step on the global
    batch, the masks replayed; returns the disagreements there (None elsewhere)."""
    from speechflow_torch import serving
    from speechflow_torch.parallel import distributed as D
    from speechflow_torch.training.trainer import _place

    model = serving.init_random_(trainer.model, torch.Generator(device="cuda").manual_seed(0))
    rates = {m: m.dropout for m in model.modules() if isinstance(getattr(m, "dropout", None),
                                                                 float)}
    no_dropout(model)
    inputs, targets = _place(trainer.batch_processor(batch), torch.device("cuda"))
    b = inputs.mel.shape[0]
    shape = (b * world, *inputs.mel.shape[1:])
    names = [n for n, _ in model.named_parameters()]

    def grads(draws, dp: bool):
        for p in model.parameters():
            p.grad = None
        with D.data_parallel_step(dp):
            losses = trainer.criterion(model(batch_in, training=True, cfm_draws=draws),
                                       batch_tgt, 0)
            sum(losses.values()).backward()
        g = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
        lv = [v.detach().float() for v in losses.values()]
        if dp:
            g, lv = D.mean_over_ranks(g), D.mean_over_ranks(lv)
        return ({k: float(v) for k, v in zip(losses, lv)},
                {n: v.detach().clone() for n, v in zip(names, g)})

    batch_in, batch_tgt = inputs, targets
    draws = ddp_draws(torch, model, slice(rank * b, (rank + 1) * b), shape)
    pins: dict = {}
    real_sum = D._all_reduce_sum
    with uncounted():
        with pinned_relus(model, pins):
            got = grads(draws, True)
        D._all_reduce_sum = lambda x: x.detach().clone() * D.process_count()
        try:
            with pinned_relus(model, pins):
                bad = grads(draws, True)
        finally:
            D._all_reduce_sum = real_sum
        parts = ddp_gather(torch, (batch, [m.cpu() for m in pins["masks"]]))
        out = None
        if rank == 0:
            glob = concat_rows([bt for bt, _ in parts])
            batch_in, batch_tgt = _place(trainer.batch_processor(glob), torch.device("cuda"))
            ref_pins = {"masks": [torch.cat(ms) for ms in zip(*(m for _, m in parts))]}
            with pinned_relus(model, ref_pins):
                ref = grads(ddp_draws(torch, model, slice(None), tuple(batch_in.mel.shape)),
                            False)
            out = {"shape": tuple(batch_in.mel.shape), "flips": ref_pins["flips"],
                   "n": len(ref[1]), "got": tts_disagreement(ref, got),
                   "bad": tts_disagreement(ref, bad)}
    for m, r in rates.items():
        m.dropout = r
    for p in model.parameters():
        p.grad = None
    del got, bad, parts, batch_in, batch_tgt, inputs, targets
    torch.cuda.empty_cache()
    return out


def ddp_gan_gate(torch, gan, batch, rank: int, world: int) -> tp.Optional[dict]:
    """On every rank, before its first micro-batch: float64 copies of both models
    through the plain versions take ``GANTrainer``'s own ``use_mesh`` step on the
    rank's first ``DDP_GATE_WAVE`` rows and samples (SGD at lr 1, no clip: the
    update is the averaged gradient, whose scale Adam's first step and a clip would
    hide; float64 everywhere, so the batch split rounds at ~1e-15), the
    discriminators' kinks recorded. From the same weights, two planted faults: a
    rank that skips the all-reduce, and the STFT loss's spectral convergence
    normalised by the rank's own norms. Rank 0 gathers the rows and kinks and takes
    one process's step (no mesh) on the global rows, kinks replayed. Returns on
    rank 0 the worst update error of each run, of each tensor's largest update."""
    import copy
    import dataclasses

    import numpy as np

    from speechflow_torch.models.vocoder import criterion
    from speechflow_torch.parallel import distributed as D
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.optimizer import OptimizerConfig
    from speechflow_torch.training.trainer import TrainerConfig

    rows, n = DDP_GATE_WAVE
    dev = gan.device
    sgd = OptimizerConfig(method="sgd", lr=1.0, lr_schedule="ConstLR", grad_clip=None,
                          betas=(0.0, 0.999), grad_accum=1)
    models = [copy.deepcopy(m).double() for m in (gan.generator, gan.discriminator)]
    init = [{k: v.clone() for k, v in m.state_dict().items()} for m in models]
    wav = np.asarray(batch.waveform[:rows, :n], np.float64)

    def trainer(mesh: bool):
        return GANTrainer(*models, gan.gen_criterion, gan.disc_criterion, gan.batch_processor,
                          gen_optimizer=sgd, disc_optimizer=sgd,
                          config=TrainerConfig(use_mesh=mesh, seed=gan.cfg.seed),
                          disc_every=gan.disc_every, disc_start_iter=gan.disc_start_iter)

    def update(t, rows_wav, pins=None):
        """One step of ``t`` from the initial weights: (losses, {parameter: update})."""
        for m, w in zip(models, init):
            m.load_state_dict(w)
        with pinned_kinks(torch, pins) if pins is not None else contextlib.nullcontext():
            losses = t.training_step({"waveform": rows_wav})
        return ({k: float(v) for k, v in losses.items()},
                {f"{tag}.{k}": v.detach() - w[k] for tag, m, w in zip(("gen", "disc"), models, init)
                 for k, v in m.named_parameters()})

    def local_norm_ratio(diff, ref, eps=1e-6):
        return torch.linalg.norm(diff) / torch.clamp(torch.linalg.norm(ref.detach()), min=eps)

    pins: dict = {}
    devices = [dev.index or 0] if dev.type == "cuda" else []
    with uncounted(), plain_versions(), torch.random.fork_rng(devices=devices):
        t = trainer(True)
        got = update(t, wav, pins)
        reduce = t.gen_opt.reduce_grads, t.disc_opt.reduce_grads
        t.gen_opt.reduce_grads = t.disc_opt.reduce_grads = None
        skip = update(t, wav)
        t.gen_opt.reduce_grads, t.disc_opt.reduce_grads = reduce
        real_ratio, criterion.norm_ratio = criterion.norm_ratio, local_norm_ratio
        try:
            local = update(t, wav)
        finally:
            criterion.norm_ratio = real_ratio
        parts = ddp_gather(torch, (wav, [m.cpu() for m in pins["masks"]]))
        out = None
        if rank == 0:
            ref_pins = {"masks": [torch.cat(ms).to(dev) for ms in zip(*(m for _, m in parts))]}
            glob = np.concatenate([w for w, _ in parts])
            ref = update(trainer(False), glob, ref_pins)
            losses = max(abs(got[0][k] - v) / max(abs(v), 1e-30) for k, v in ref[0].items())
            out = {"shape": glob.shape, "n": len(ref[1]), "flips": ref_pins["flips"],
                   "losses": losses, "got": worst_relative(ref[1], got[1]),
                   "skip": worst_relative(ref[1], skip[1]),
                   "local": worst_relative(ref[1], local[1])}
    del models, init, t, got, skip, local, parts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ddp_rank_run(torch, kind: str, rank: int, world: int, tmp: Path) -> dict:
    """One rank's ``train_tts.train`` (``kind`` "tts") or ``train_vocoder.train``
    ("gan") with ``use_mesh``: the samples of each step, ms a step, the loader's wait,
    peak memory, launches, a digest of the weights after the last step."""
    import hashlib

    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts import train_vocoder as TV
    from speechflow_torch.scripts.common import experiment_saver
    from speechflow_torch.server.loader import DataLoader
    from speechflow_torch.training.gan_trainer import GANTrainer
    from speechflow_torch.training.trainer import Trainer

    if kind == "tts":
        model_cfg, data_cfg = TT.configs("default", data_root=SEGS)
        model_cfg["batch"]["size"] = DDP_TTS_BATCH
        model_cfg["experiment"]["train_g2p"] = False
        steps, cls, train, gate = DDP_TTS_STEPS, Trainer, TT.train, ddp_tts_gate
    else:
        model_cfg, data_cfg = TV.configs(TRAIN_PRESET, data_root=SEGS)
        steps, cls, train, gate = DDP_GAN_MICRO_BATCHES, GANTrainer, TV.train, ddp_gan_gate
    model_cfg["trainer"].update(max_steps=steps, ckpt_every=steps, use_mesh=True)
    saver = experiment_saver(model_cfg, data_cfg, tmp / f"{kind}_exp") if rank == 0 else None
    rec: dict = {"keys": [], "ms": [], "wait_s": 0.0, "vjp_launches": []}
    real_next, real_step = DataLoader.next_batch, cls.training_step

    def next_batch(self, timeout: float = 120.0):
        batch = real_next(self, timeout=DDP_COLLECTIVE_S)
        if self.subset == "train":
            rec["keys"].append(list(self.last_keys))
            rec["wait_s"] = self.wait_s
        return batch

    owner: list = []  # the trainer that train() built

    def step(self, batch):
        if not owner:
            owner.append(self)
        if self is not owner[0]:  # a trainer of the GAN gate's own
            return real_step(self, batch)
        if "gate" not in rec:
            ddp_mark(rank, f"{kind}: first batch in hand")
            rec["gate"] = gate(torch, self, batch, rank, world)
            ddp_mark(rank, f"{kind}: gate done")
        torch.cuda.synchronize()
        vjp_before = read_vjp_counts()
        t0 = time.perf_counter()
        out = real_step(self, batch)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["vjp_launches"].append({k: v - vjp_before[k] for k, v in read_vjp_counts().items()})
        ddp_mark(rank, f"{kind}: step {len(rec['ms'])} in {rec['ms'][-1]:.0f} ms")
        return out

    def done(trainer, last):
        if trainer.global_step == steps:
            models = [trainer.model] if kind == "tts" else [trainer.generator,
                                                            trainer.discriminator]
            h = hashlib.sha256()
            for m in models:
                for p in m.parameters():
                    h.update(p.detach().cpu().numpy().tobytes())
            rec["digest"] = h.hexdigest()

    DataLoader.next_batch, cls.training_step = next_batch, step
    ddp_mark(rank, f"{kind}: train() starts")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rec["expr"] = train(model_cfg, data_cfg, saver, device="cuda", callbacks=[done])
        rec["fit_s"] = time.perf_counter() - t0
        ddp_mark(rank, f"{kind}: train() returned")
    finally:
        DataLoader.next_batch, cls.training_step = real_next, real_step
    rec.update(launches=read_counts(), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return rec


def ddp_mark(rank: int, what: str) -> None:
    """A rank's progress, with the seconds since the phase began."""
    t = time.time() - float(os.environ.get("SPEECHFLOW_DDP_T0", time.time()))
    print(f"[ddp] rank {rank} at {t:.1f} s: {what}", flush=True)


def ddp_rank(rank: int, world: int, port: int, tmp: str, t0: float) -> None:
    """A rank under the environment contract: acoustic model, then vocoder GAN."""
    import pickle

    import torch

    os.environ.update(SPEECHFLOW_COORDINATOR=f"127.0.0.1:{port}",
                      SPEECHFLOW_NUM_PROCESSES=str(world), SPEECHFLOW_PROCESS_ID=str(rank),
                      SPEECHFLOW_DDP_T0=str(t0))
    sys.path.insert(0, str(REPO))
    from speechflow_torch.parallel import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.init_distributed(device="cuda", timeout_s=DDP_COLLECTIVE_S)
    ddp_mark(rank, f"joined the process group ({D.backend()})")
    try:
        out = {"backend": D.backend(),
               "tts": ddp_rank_run(torch, "tts", rank, world, Path(tmp)),
               "gan": ddp_rank_run(torch, "gan", rank, world, Path(tmp))}
    finally:
        D.shutdown_distributed()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def ddp_spawn(tmp: Path) -> list:
    """``DDP_WORLD`` ranks started and joined within ``DDP_TIMEOUT_S``; when one fails
    the others are stopped and the phase fails (its traceback is on stderr)."""
    import pickle

    from speechflow_torch.concurrency.context import worker_context
    from speechflow_torch.server.transport import find_free_port

    ctx = worker_context()  # forks of a server that imported torch, not of this process
    port = find_free_port()
    t0 = time.time()
    procs = [ctx.Process(target=ddp_rank, args=(r, DDP_WORLD, port, str(tmp), t0),
                         name=f"rank{r}") for r in range(DDP_WORLD)]
    deadline = t0 + DDP_TIMEOUT_S
    try:
        for p in procs:
            p.start()
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            check(not failed, "ddp: " + ", ".join(f"{p.name} exited with {p.exitcode}"
                                                 for p in failed))
            check(time.time() < deadline, f"ddp: the ranks did not finish in {DDP_TIMEOUT_S} s")
            procs[0].join(0.5)
        check(all(p.exitcode == 0 for p in procs),
              f"ddp: rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(DDP_WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def ddp_check_tts(torch, ranks: list, tmp: Path, gpu_line: str) -> dict:
    """The samples, the gradient gate and its planted fault, the weights, the
    checkpoint: rank 0's alone, served one request kernels vs plain."""
    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.server import sample_key
    from speechflow_torch.training.saver import ExperimentSaver

    runs = [r["tts"] for r in ranks]
    model_cfg, data_cfg = TT.configs("default", data_root=SEGS)
    # the samples: each step's two parts disjoint, together one process's global batch
    pipeline = DataPipeline.from_config(TT.data_config_of(model_cfg, data_cfg))
    want = [[sample_key(s) for s in pipeline.samplers["train"].sampling(DDP_TTS_BATCH)[0]]
            for _ in range(DDP_TTS_STEPS)]
    for k in range(DDP_TTS_STEPS):
        parts = [r["keys"][k] for r in runs]
        check(not set(parts[0]) & set(parts[1]), f"ddp: step {k + 1}'s ranks share samples")
        check(parts[0] + parts[1] == want[k],
              f"ddp: step {k + 1}'s samples are not one process's global batch")
    check(runs[0]["digest"] == runs[1]["digest"],
          "ddp: the ranks' weights differ after the last step")
    # only rank 0 wrote: one experiment, its checkpoint at the last step
    exps = sorted((tmp / "tts_exp").iterdir())
    ckpt = ExperimentSaver.get_last_checkpoint(exps[0]) if len(exps) == 1 else None
    check(ckpt is not None and ckpt.name == f"step_{DDP_TTS_STEPS:09d}"
          and runs[0]["expr"] == runs[1]["expr"] == str(exps[0]),
          f"ddp: experiments {exps}, checkpoint {ckpt}")

    # the gate: rank 0's averaged gradients against one process on the global batch
    gate = runs[0]["gate"]
    (loss_err, grad_err, where), (f_loss, f_grad, f_where) = gate["got"], gate["bad"]
    print(f"[ddp] acoustic model (tts_model.yml default, f32, TF32 off): {DDP_WORLD} ranks x "
          f"{gate['shape'][0] // DDP_WORLD} of the global batch {gate['shape']}, step 1's "
          f"gradients (seeded random weights, dropout 0, injected draws) averaged over the "
          f"ranks against one process on the card (rank 0): worst loss error {loss_err:.3g} "
          f"(tol {TOL_F32_REL:g}), {gate['n']} gradients, worst {grad_err:.3g} of scale "
          f"({where}; tol {TOL_TTS_GRAD:g}; {gate['flips']} ReLU pre-activations pinned "
          f"across 0); planted fault (each rank's own valid-frame count): worst {f_grad:.3g} "
          f"({f_where}) ({gpu_line})", flush=True)
    check(loss_err <= TOL_F32_REL and grad_err <= TOL_TTS_GRAD,
          f"ddp: the ranks' gradients disagree with one process: {where} {grad_err}")
    check(f_grad > TOL_TTS_GRAD, "ddp: the gate passes local normalisers (planted fault)")
    tree, payload = ExperimentSaver.load_checkpoint(ckpt)

    # rank 0's checkpoint serves a request, kernels against plain
    ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt, device="cuda")
    _, voc_params = serving.flagship_params()
    vm = seeded_vocoder(torch, voc_params)
    vi = VocoderEvaluationInterface(vm)
    ctx = ti.prepare_embeddings(ti.create_context("EN", ti.get_speakers()[0]))
    opts = TTSOptions(t_out=T_FRAMES)
    sentences = list(TTS_TRAIN_REQUEST)
    noise = torch.randn(ti.model.noise_shape(ti.prepare_batch(sentences, ctx, opts), T_FRAMES),
                        generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda") * ti.model.decoder.temperature
    reset_counts()
    got = tts_request(torch, ti, vi, sentences, ctx, opts, noise=noise)
    served = read_counts()
    with uncounted(), plain_versions():
        ref = tts_request(torch, ti, vi, sentences, ctx, opts, noise=noise)
    mel_err = (got["out"].spectrogram - ref["out"].spectrogram).abs().max().item()
    mel_lim = rel_limit(ref["out"].spectrogram)
    wav_err = float(np.abs(got["wave"] - ref["wave"]).max())
    wav_lim = TOL_F32_REL * float(np.abs(ref["wave"]).max())
    print(f"[ddp] rank 0's {ckpt.name} (the only experiment) -> TTSEvaluationInterface, f32: "
          f"{len(sentences)} sentences, kernels vs plain: mel max_abs_err {mel_err:.3g} (tol "
          f"{mel_lim:.3g}), wave {wav_err:.3g} (tol {wav_lim:.3g}); launches {served}",
          flush=True)
    check(mel_err <= mel_lim and wav_err <= wav_lim,
          "ddp: the checkpoint's request with the kernels disagrees with the plain versions")
    check(served == EXPECTED_LAUNCHES, f"ddp: the request's launches {served}")
    del ti, vi, vm, got, ref
    torch.cuda.empty_cache()
    return served


def ddp_check_gan(torch, ranks: list, gpu_line: str) -> None:
    """The GAN gate (rank 0's): the ranks' float64 ``GANTrainer`` updates against one
    process's, within ``TOL_DDP_F64``; both planted faults outside it."""
    runs = [r["gan"] for r in ranks]
    check(runs[0]["digest"] == runs[1]["digest"],
          "ddp: the ranks' generator and discriminator differ after the optimizer step")
    gate = runs[0]["gate"]
    (err, where), (skip, s_where), (local, l_where) = gate["got"], gate["skip"], gate["local"]
    print(f"[ddp] vocoder GAN ({TRAIN_PRESET} recipe; GANTrainer's own use_mesh step in "
          f"float64 through the plain versions, SGD at lr 1): {DDP_WORLD} ranks x "
          f"{DDP_GATE_WAVE} against one process on {gate['shape']} (rank 0): worst loss "
          f"error {gate['losses']:.3g}, {gate['n']} updates, worst {err:.3g} of the tensor's "
          f"largest update ({where}; tol {TOL_DDP_F64:g}; {gate['flips']} kink elements "
          f"crossed 0, pinned); planted faults: a rank that skips the all-reduce {skip:.3g} "
          f"({s_where}), the spectral convergence of the rank's own norms {local:.3g} "
          f"({l_where}) ({gpu_line})", flush=True)
    check(err <= TOL_DDP_F64 and gate["losses"] <= TOL_DDP_F64,
          f"ddp: the GAN updates disagree with one process: {where} {err}")
    check(skip > TOL_DDP_F64, "ddp: the GAN gate passes a rank that skips the all-reduce")
    check(local > TOL_DDP_F64, "ddp: the GAN gate passes per-rank STFT normalisers")


def phase_ddp(torch, gpu_line: str) -> dict:
    """Data-parallel training through ``train_tts.train`` and ``train_vocoder.train`` on
    ``DDP_WORLD`` ranks of the one card (the environment contract, gloo), rank
    0's data server feeding both."""
    import multiprocessing as mp
    import statistics
    import tempfile

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="ddp_", dir=workdir()))
    ranks = ddp_spawn(tmp)
    print(f"[ddp] {DDP_WORLD} ranks started, trained and joined in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    for kind, what in (("tts", "acoustic model, step"), ("gan", "vocoder GAN, micro-batch")):
        for r, rank in enumerate(ranks):
            run = rank[kind]
            vjp_kernels = {k: sum(v[k] for v in run["vjp_launches"]) for k in TRAIN_VJP_LAUNCHES}
            print(f"[ddp] rank {r} {what}s: {len(run['ms'])}, ms each "
                  + " ".join(f"{v:.1f}" for v in run["ms"])
                  + f" (median of 2.. {statistics.median(run['ms'][1:]):.1f}); train() "
                  f"{run['fit_s']:.1f} s with set-up; waited on its loader {run['wait_s']:.1f} s; "
                  f"peak device memory {run['peak_gib']:.2f} GiB; launches {run['launches']}, "
                  f"anti-alias VJP kernels {vjp_kernels}; backend {rank['backend']} ({gpu_line})",
                  flush=True)
    check(all(r["backend"] == "gloo" for r in ranks), "ddp: the ranks' backend is not gloo")
    served = ddp_check_tts(torch, ranks, tmp, gpu_line)
    ddp_check_gan(torch, ranks, gpu_line)
    train = {k: sum(r[kind]["launches"][k] for r in ranks for kind in ("tts", "gan"))
             for k in served}
    check(all(r["gan"]["launches"][k] > 0 for r in ranks for k in HEAD_LAUNCHES),
          "ddp: a rank's GAN step launched no anti-alias kernel")
    for r, rank in enumerate(ranks):
        got = rank["gan"]["vjp_launches"]
        check(len(got) == DDP_GAN_MICRO_BATCHES and all(v == TRAIN_VJP_LAUNCHES for v in got),
              f"ddp: rank {r}'s VJP kernel launches a micro-batch {got} != "
              f"{TRAIN_VJP_LAUNCHES}")
    children = mp.active_children()
    check(not children, f"ddp: processes still alive: {children}")
    phase_s = time.perf_counter() - t_phase
    print(f"[ddp] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    return {"launches": {k: train[k] + served[k] for k in served}, "phase_s": phase_s}


# -- phase 26: adafactor, the loss zoo, MixStyle and PreNet, a pruned checkpoint ---------

ADAFACTOR_RECORD = JAX_FIXTURE / "resume_adafactor_record.npz"
ADAFACTOR_BATCH = 16  # the cut: B16 of the SEGS train utterances
ADAFACTOR_STEPS = 3  # the cut: step 1 at lr 0, then 2 that move the weights
ADAFACTOR_G2P_STEPS = 100  # the cut of train_tts's G2P (1200 a member in the recipe)
ADAFACTOR_UPDATES = 3  # seeded-gradient updates of the full-width model, card vs CPU
ADAFACTOR_SENTENCES = REQUEST_SENTENCES[:4]  # the pruned checkpoint's request
# the zoo's losses at the shapes a recipe gives them, each on the card (f32) against the
# CPU (float64): value within TOL_F32_REL of its magnitude, gradient of its largest
ZOO_SHAPES = {"GuidedAttention": (16, 1024, 128), "MLE": (16, 1024, 80),
              "DiffSpectral": (40, 1024, 80), "SSIM": (40, 1024, 80), "Duration": (40, 128),
              "VAE": (40, 256), "InverseSpeaker": (40, 256), "SoftDTW": (16, 256, 1)}
MIXSTYLE_SHAPE = (40, 1024, 768)
PRENET_DIMS = (80, 256, 256)
# a loss's gradient, card f32 against CPU float64, of its largest magnitude: SSIM's
# variances (E[x²] - E[x]² over 121-element windows) cancel two digits of f32 (5.7e-5 on
# the CPU), as TOL_TTS_GRAD holds a training step's gradients
TOL_ZOO_GRAD = 1e-3


def _timed_ms(torch, fn) -> tuple:
    """(fn's result, its host ms, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _jax_entries(st: dict, shapes: dict) -> dict:
    """A parameter's adafactor entries in JAX's layout, whose shapes are ``shapes`` (a
    faulty run's torch-layout entries reversed back, as such a port would save them)."""
    return {k: v if tuple(v.shape) == shapes[k] else v.permute(*range(v.ndim)[::-1])
            for k, v in st.items() if k in shapes}


def planted_torch_axes_fault(opt) -> None:
    """The fault: adafactor's factored axes taken from the torch shape. Every parameter
    is computed in its torch layout, its loaded JAX entries moved onto that layout by
    reversing their axes where the shapes differ: the shapes then fit, and only a
    parameter whose largest axes tie (the (5, 128, 128) conv) factors other axes."""
    base = opt.base
    for p in opt.params:
        st = base.state[p]
        base.layouts.pop(p, None)
        for k, shape in base.state_shapes(p).items():
            v = st[k]
            st[k] = v if tuple(v.shape) == shape else \
                v.permute(*range(v.ndim)[::-1]).contiguous()
            check(tuple(st[k].shape) == shape, f"planted fault: {k} {tuple(v.shape)} vs {shape}")


def adafactor_resume_step(torch, device: str, fault: bool = False) -> dict:
    """The JAX adafactor run of ``tests/data/jax_checkpoints/resume_adafactor`` resumed on
    ``device`` as ``-r`` resumes it, every dropout rate 0, one step on the recorded batch:
    losses within TOL_F32_REL of JAX's next step, sampled parameters within two steps'
    lr and each sampled ``v_row`` / ``v_col`` / ``v`` within TOL_RESUME_MOMENT of its
    entry's scale. ``fault`` plants ``planted_torch_axes_fault``; returns the worst
    shares of their limits (a rejection is a share above 1)."""
    import numpy as np

    from speechflow_torch.convert import flatten_nnx, jax_layouts, nnx_from_module
    from speechflow_torch.io.config import value_select, yaml_load
    from speechflow_torch.training.optimizer import Adafactor

    rec = np.load(ADAFACTOR_RECORD)
    cfg = value_select(yaml_load(str(rec["tts/config_yaml"])), ["debug"])
    trainer = resumed_tts_trainer(torch, cfg, JAX_FIXTURE / "resume_adafactor" / "tts", device)
    model = trainer.model
    check(isinstance(trainer.optimizer.base, Adafactor), "adafactor: the recipe's optimizer")
    step0, count0 = trainer.global_step, trainer.optimizer.count
    shapes = {p: trainer.optimizer.base.state_shapes(p) for p in trainer.optimizer.params}
    if fault:
        planted_torch_axes_fault(trainer.optimizer)
    losses = trainer.training_step(recorded_tts_batch(torch, rec))
    check(all(f"tts/loss/{k}" in rec.files for k in losses),
          f"adafactor resume: losses {sorted(losses)} not all in the record")
    loss_err = max(abs(float(losses[k]) - float(rec[f"tts/loss/{k}"]))
                   / max(abs(float(rec[f"tts/loss/{k}"])), 1e-6) for k in losses)
    opt = trainer.optimizer
    lr = opt.schedule(count0)
    by_src = {src: name for name, (src, _, _) in jax_layouts(model).items()}
    params = dict(model.named_parameters())
    trees = {"param": flatten_nnx(nnx_from_module(model))}
    for name, p in params.items():
        for k, v in _jax_entries(opt.base.state[p], shapes[p]).items():
            trees.setdefault(k, {})[name] = v.detach().float().cpu().numpy()
    worst, factored = {}, 0
    for entry, tree in trees.items():
        keys = [k[len(f"tts/{entry}/idx/"):] for k in rec.files
                if k.startswith(f"tts/{entry}/idx/")]
        got_keys = set(tree) if entry == "param" else {
            src for src, name in by_src.items() if name in tree}
        check(set(keys) == got_keys, f"adafactor resume: the record's {entry} leaves are not "
                                     f"the optimizer's: {sorted(set(keys) ^ got_keys)[:4]}")
        scale = max(float(np.abs(rec[f"tts/{entry}/{k}"]).max()) for k in keys)
        errs = []
        for k in keys:
            arr = tree[k] if entry == "param" else tree[by_src[k]]
            got = arr.reshape(-1)[rec[f"tts/{entry}/idx/{k}"]]
            lim = 2 * lr if entry == "param" else TOL_RESUME_MOMENT * scale
            errs.append((float(np.abs(got - rec[f"tts/{entry}/{k}"]).max()) / max(lim, 1e-30),
                         k))
        worst[entry] = max(errs)
        factored += len(keys) if entry == "v_row" else 0
    return {"loss_err": loss_err, "worst": worst, "step0": step0, "count0": count0,
            "counts": (trainer.global_step, opt.count), "factored": factored,
            "leaves": len(params)}


def adafactor_resume(torch, gpu_line: str) -> dict:
    """The committed JAX adafactor run resumed on the card, and with the planted fault."""
    t0 = time.perf_counter()
    res = adafactor_resume_step(torch, "cuda")
    ms = 1e3 * (time.perf_counter() - t0)
    bad = adafactor_resume_step(torch, "cuda", fault=True)
    shares = {k: v[0] for k, v in res["worst"].items()}
    print(f"[adafactor_zoo] the JAX adafactor run (tests/data/jax_checkpoints/resume_adafactor, "
          f"{res['factored']} of {res['leaves']} leaves factored) resumed at step {res['step0']} "
          f"on the card ({ms:.1f} ms with the resume): losses against JAX's next step "
          f"{res['loss_err']:.3g} of the loss (tol {TOL_F32_REL:g}); worst share of the limit "
          + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in res["worst"].items())
          + f"; planted fault (factored axes from the torch shape): "
          + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in bad["worst"].items())
          + f" ({gpu_line})", flush=True)
    check(res["step0"] == res["count0"] == 2 and res["counts"] == (3, 3),
          f"adafactor resume: steps {res['step0']}, {res['count0']} -> {res['counts']}")
    check(res["loss_err"] <= TOL_F32_REL and max(shares.values()) <= 1,
          "adafactor resume: the resumed step disagrees with JAX's")
    check(max(v[0] for v in bad["worst"].values()) > 1,
          "adafactor resume: the check passed the planted torch-axes fault")
    return {"loss_err": res["loss_err"], "shares": shares, "ms": ms,
            "fault_share": max(v[0] for v in bad["worst"].values())}


def adafactor_updates(torch, module, cfg, device: str, dtype, ref: tp.Optional[list] = None,
                      fault: bool = False):
    """``ADAFACTOR_UPDATES`` updates of ``module`` (a copy, on ``device`` in ``dtype``)
    from seeded gradients (float64 normals drawn on the card, from one seed) through
    the recipe's chain. Without ``ref``: each step's updates by name (on ``device``,
    float64) with their largest magnitude. With ``ref`` (such a list): the worst error
    of an update against its reference, of the reference's largest, as (error, step,
    name), each compared where it is made. ``fault`` drops the 1e-3 floor of the
    parameter scale."""
    import copy

    from speechflow_torch.training.optimizer import build_optimizer

    model = copy.deepcopy(module).to(device=device, dtype=dtype)
    opt = build_optimizer(cfg, model)
    if fault:
        opt.base.min_scale = 0.0
    names = {p: n for n, p in model.named_parameters()}
    steps, worst = [], [0.0, 0, ""]
    real = opt.base.update

    def update(p, grad, lr):
        u = real(p, grad, lr)
        name = names[p]
        if ref is None:
            d = u.detach().to(torch.float64)
            steps[-1][name] = (d, d.abs().max().item())
        else:
            r, r_max = ref[len(steps) - 1][name]
            if r_max > 0:
                err = (u.double() - r.to(u.device)).abs().max().item() / r_max
                if err > worst[0]:
                    worst[:] = [err, len(steps), name]
        return u

    opt.base.update = update
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(ADAFACTOR_UPDATES):
        steps.append({})
        for n, p in model.named_parameters():
            p.grad = torch.randn(p.shape, generator=gen, dtype=torch.float64,
                                 device="cuda").to(device, dtype)
        opt.step()
    return steps if ref is None else tuple(worst)


def adafactor_gate(torch, model_cfg: dict, data_cfg: dict, gpu_line: str) -> dict:
    """The full-width model's adafactor updates from seeded gradients: the card in f32
    against the CPU in float64, each within TOL_F32_REL of its tensor's largest; the
    same gate must reject the planted fault (no floor on the parameter scale: a
    zero-initialised tensor, as the DiT blocks' modulations, never moves)."""
    from speechflow_torch.data.core.components import DataPipeline
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import optimizer_config

    pipeline = DataPipeline.from_config(data_cfg)
    torch.manual_seed(0)
    with torch.device("cuda"):
        _, module, _, _ = TT.build_model(model_cfg, pipeline)
    cfg = optimizer_config(model_cfg)
    zeros = [n for n, p in module.named_parameters() if not p.any()]
    t0 = time.perf_counter()
    cpu = adafactor_updates(torch, module, cfg, "cpu", torch.float64)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    err = adafactor_updates(torch, module, cfg, "cuda", torch.float32, ref=cpu)
    card_s = time.perf_counter() - t0
    bad = adafactor_updates(torch, module, cfg, "cuda", torch.float32, ref=cpu, fault=True)
    moved = all(cpu[-1][n][1] > 0 for n in zeros)
    step_ms = optimizer_step_ms(torch, module, cfg)
    print(f"[adafactor_zoo] the recipe's chain over the full-width model ({len(cpu[0])} "
          f"tensors, {len(zeros)} zero at init), {ADAFACTOR_UPDATES} updates from seeded "
          f"gradients, card f32 against CPU float64: worst {err[0]:.3g} of a tensor's largest "
          f"(update {err[1]}, {err[2]}; tol {TOL_F32_REL:g}); {ADAFACTOR_UPDATES} updates "
          f"{cpu_s:.1f} s on the CPU, {card_s:.1f} s on the card with the comparison; planted "
          f"fault (no 1e-3 floor): {bad[0]:.3g} ({bad[2]}); the optimizer step alone "
          f"(synchronised, median of 3): adafactor {step_ms['adafactor']:.1f} ms, the "
          f"recipe's adamw {step_ms['adamw']:.1f} ms ({gpu_line})", flush=True)
    check(moved, "adafactor gate: a zero-initialised tensor never moved on the CPU")
    check(err[0] <= TOL_F32_REL, "adafactor gate: the card's updates disagree with the CPU's")
    check(bad[0] > TOL_F32_REL, "adafactor gate: the planted fault (no floor) passed")
    return {"err": err[0], "fault": bad[0], "cpu_s": cpu_s, "card_s": card_s, **step_ms}


def optimizer_step_ms(torch, module, cfg) -> dict:
    """The chain's step (``Optimizer.step``: the finite check, the clip, the base step,
    the windows) on the card in f32, median of 3 after one, with adafactor and with
    the recipe's own adamw, from the same seeded gradients."""
    import copy
    import dataclasses
    import statistics

    from speechflow_torch.training.optimizer import build_optimizer

    out = {}
    for method in ("adafactor", "adamw"):
        model = copy.deepcopy(module).float()
        opt = build_optimizer(dataclasses.replace(cfg, method=method), model)
        gen = torch.Generator(device="cuda").manual_seed(1)
        grads = [torch.randn(p.shape, generator=gen, device="cuda") for p in model.parameters()]
        times = []
        for _ in range(4):
            for p, g in zip(model.parameters(), grads):
                p.grad = g
            times.append(_timed_ms(torch, opt.step)[1])
        out[method] = statistics.median(times[1:])
        del model, opt, grads
    torch.cuda.empty_cache()
    return out


def _zoo_inputs(torch, name: str, gen):
    """(output, target, call kwargs) of loss ``name`` at its recipe shape, float64 on
    the CPU (SSIM's values inside its range and the target near the output, away from
    the clip's and max(., 0)'s kinks)."""
    shape = ZOO_SHAPES[name]

    def rnd(*s, lo=None, hi=None):
        if lo is None:
            return torch.randn(s, generator=gen, dtype=torch.float64)
        return lo + (hi - lo) * torch.rand(s, generator=gen, dtype=torch.float64)

    b = shape[0]
    lens = torch.linspace(shape[1], shape[1] // 2, b).long() if len(shape) > 2 else None
    if name == "GuidedAttention":
        att = torch.softmax(rnd(*shape), dim=-1)
        return att, None, {"out_lengths": lens,
                           "in_lengths": torch.linspace(shape[2], shape[2] // 3, b).long()}
    if name == "MLE":
        return (rnd(*shape), rnd(b)), None, {"lengths": lens}
    if name == "DiffSpectral":
        return rnd(*shape), rnd(*shape), {"lengths": lens}
    if name == "SSIM":
        out = rnd(*shape, lo=-3.0, hi=3.0)
        return out, (out + 0.3 * rnd(*shape)).clamp(-3.5, 3.5), {"lengths": lens}
    if name == "Duration":
        return rnd(*shape), rnd(*shape, lo=0.5, hi=20.0), {}
    if name == "VAE":
        return (rnd(*shape), 0.3 * rnd(*shape)), None, {}
    if name == "InverseSpeaker":
        return rnd(*shape), torch.randint(0, shape[1], (b,), generator=gen), {}
    return rnd(*shape), rnd(*shape), {}  # SoftDTW


def _loss_and_grads(torch, loss, output, target, kw, device, dtype) -> tuple:
    """(value, gradients of the output tensors) of ``loss`` on ``device`` in ``dtype``."""
    def to(x):
        return x.to(device, dtype if x.is_floating_point() else x.dtype)

    outs = [to(o).requires_grad_() for o in (output if isinstance(output, tuple) else (output,))]
    tgt = None if target is None else to(target)
    kwd = {k: (v if v is None else v.to(device)) for k, v in kw.items()}
    val = loss(tuple(outs) if isinstance(output, tuple) else outs[0], tgt, **kwd)
    grads = torch.autograd.grad(val, outs)
    return val.detach(), grads


def loss_zoo_gate(torch, gpu_line: str) -> dict:
    """Each of the zoo's eight new losses, value and gradient, on the card (f32)
    against the CPU (float64) at its recipe shape; the soft-DTW timed forward and
    backward, and its planted fault (the diagonal dropped from the soft-min) rejected."""
    from speechflow_torch.training.losses import build_loss
    from speechflow_torch.training.losses import zoo

    gen = torch.Generator().manual_seed(0)
    res = {}
    for name in ZOO_SHAPES:
        output, target, kw = _zoo_inputs(torch, name, gen)
        loss = build_loss(name)
        ref_v, ref_g = _loss_and_grads(torch, loss, output, target, kw, "cpu", torch.float64)
        (val, grads), ms = _timed_ms(
            torch, lambda: _loss_and_grads(torch, loss, output, target, kw, "cuda",
                                           torch.float32))
        v_err = abs(val.item() - ref_v.item()) / max(abs(ref_v.item()), 1e-12)
        g_err = max((g.double().cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-300)
                    for g, r in zip(grads, ref_g))
        res[name] = {"value": ref_v.item(), "value_err": v_err, "grad_err": g_err, "ms": ms}
        check(bool(torch.isfinite(val)) and v_err <= TOL_F32_REL and g_err <= TOL_ZOO_GRAD,
              f"loss zoo: {name} on the card disagrees with the CPU: value {v_err:.3g} (tol "
              f"{TOL_F32_REL:g}), gradient {g_err:.3g} (tol {TOL_ZOO_GRAD:g})")
    # the soft-DTW's wavefront: forward and backward timed; the planted fault
    output, target, _ = _zoo_inputs(torch, "SoftDTW", gen)
    loss = build_loss("SoftDTW")
    x, y = output.float().cuda().requires_grad_(), target.float().cuda()
    fwd = cuda_ms(lambda: loss(x, y), iters=3, warmup=1)
    both = cuda_ms(lambda: torch.autograd.grad(loss(x, y), x), iters=3, warmup=1)
    ref_v, ref_g = _loss_and_grads(torch, loss, output, target, {}, "cpu", torch.float64)
    real = zoo._softmin
    zoo._softmin = lambda a, b, c, gamma: real(a, b, torch.full_like(c, zoo.SOFT_DTW_BIG), gamma)
    try:
        bad_v, _ = _loss_and_grads(torch, loss, output, target, {}, "cuda", torch.float32)
    finally:
        zoo._softmin = real
    bad = abs(bad_v.item() - ref_v.item()) / max(abs(ref_v.item()), 1e-12)
    res["SoftDTW"].update(fwd_ms=fwd, fwd_bwd_ms=both, fault=bad)
    print(f"[adafactor_zoo] the loss zoo on the card (f32) against the CPU (float64), "
          f"value (tol {TOL_F32_REL:g}) and gradient (tol {TOL_ZOO_GRAD:g}), worst of the "
          "largest: "
          + "; ".join(f"{n} {ZOO_SHAPES[n]} value {r['value_err']:.3g} grad {r['grad_err']:.3g} "
                      f"({r['ms']:.1f} ms)" for n, r in res.items())
          + f"; soft-DTW B16 x 256 x 256 ({2 * 256 - 1} anti-diagonals) forward {fwd:.2f} ms, "
          f"forward and backward {both:.2f} ms; planted fault (no diagonal in the soft-min) "
          f"{bad:.3g} of the value ({gpu_line})", flush=True)
    check(bad > TOL_F32_REL, "loss zoo: the planted soft-DTW fault passed")
    return res


def mixstyle_prenet_gate(torch, gpu_line: str) -> dict:
    """``MixStyle`` on (B40, 1024, 768) and ``PreNet`` 80 -> 256 -> 256, the draws
    injected: the card (f32) against the CPU (float64), output and input gradient."""
    from speechflow_torch.models.tts.common import MixStyle, PreNet

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(MIXSTYLE_SHAPE, generator=gen, dtype=torch.float64) * 2.0 + 1.0
    cot = torch.randn(MIXSTYLE_SHAPE, generator=gen, dtype=torch.float64)
    mix = MixStyle(p=1.0, alpha=0.1)
    draws = mix.draw(MIXSTYLE_SHAPE[0], torch.device("cpu"), gen)
    torch.manual_seed(0)
    pre = PreNet(*PRENET_DIMS).double()
    px = torch.randn(40, 1024, PRENET_DIMS[0], generator=gen, dtype=torch.float64)
    res = {}
    for name, mod, inp, call in (
            ("MixStyle", mix, x, lambda m, a, dev: m(a, draws=type(draws)(
                *(d.to(dev) for d in draws)))),
            ("PreNet", pre, px, lambda m, a, dev: m(a))):
        outs = {}
        for dev, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
            m = mod.to(dev, dtype)
            a = inp.to(dev, dtype).requires_grad_()
            y = call(m, a, dev)
            c = cot.to(dev, dtype) if name == "MixStyle" else torch.ones_like(y)
            (g,) = torch.autograd.grad(y, a, c)
            outs[dev] = (y.detach().double().cpu(), g.double().cpu())
        errs = [(outs["cuda"][i] - outs["cpu"][i]).abs().max().item()
                / outs["cpu"][i].abs().max().item() for i in (0, 1)]
        res[name] = errs
        check(max(errs) <= TOL_F32_REL, f"{name}: the card disagrees with the CPU: {errs}")
    mod = None
    print(f"[adafactor_zoo] MixStyle {MIXSTYLE_SHAPE} (draws injected, gate on) and PreNet "
          f"{' -> '.join(map(str, PRENET_DIMS))}, card f32 against CPU float64, output and "
          f"input gradient of the largest: "
          + "; ".join(f"{n} {e[0]:.3g}, {e[1]:.3g}" for n, e in res.items())
          + f" (tol {TOL_F32_REL:g}; {gpu_line})", flush=True)
    return res


def profiler_summary(log_file: Path) -> dict:
    """The ``LoggingServer``'s profiler summary at the end of an experiment's log:
    tag -> (count, mean ms)."""
    text = log_file.read_text()
    check("=== profiler summary ===" in text, f"adafactor_zoo: no profiler summary in {log_file}")
    out = {}
    for line in text.split("=== profiler summary ===", 1)[1].splitlines():
        tag, _, rest = line.partition(": n=")
        if rest:
            n, _, mean = rest.partition(" mean=")
            out[tag.strip()] = (int(n), float(mean.split("ms")[0]))
    return out


def _state_bytes(opt) -> int:
    return sum(v.numel() * v.element_size() for st in opt.base.state.values()
               for v in st.values() if hasattr(v, "numel"))


def phase_adafactor_zoo(torch, gpu_line: str) -> dict:
    """``train_tts.train`` with adafactor (a copy of ``configs/tts_model.yml`` read
    through ``-c``) under ``DATAPIPE_PROFILING=1``; the recipe chain's updates card vs
    CPU; the committed JAX adafactor run resumed; the loss zoo, MixStyle and PreNet
    card vs CPU; the run's checkpoint pruned and served."""
    import statistics
    import tempfile

    import numpy as np

    from speechflow_torch import serving
    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface, TTSOptions
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts import train_tts as TT
    from speechflow_torch.scripts.common import experiment_log, experiment_saver
    from speechflow_torch.training.optimizer import Adafactor
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.training.trainer import Trainer
    from speechflow_torch.utils.misc import prune_checkpoint

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="adafactor_", dir=workdir()))
    text = (REPO / "configs" / "tts_model.yml").read_text()
    check(text.count("  method: adamw\n") == 1, "adafactor_zoo: the recipe's optimizer line")
    model_yml = tmp / "tts_model.yml"
    model_yml.write_text(text.replace("  method: adamw\n", "  method: adafactor\n"))
    model_cfg, data_cfg = TT.configs("default", model_config=model_yml,
                                     data_root=REPO / "tests" / "data" / "SEGS")
    check(model_cfg["optimizer"]["method"] == "adafactor"
          and model_cfg["model"]["decoder_dim"] == 768, "adafactor_zoo: the copy read as "
          f"{model_cfg['optimizer']['method']}, decoder {model_cfg['model']['decoder_dim']}")
    model_cfg["batch"]["size"] = ADAFACTOR_BATCH
    model_cfg["trainer"]["max_steps"] = ADAFACTOR_STEPS
    model_cfg["experiment"]["g2p_steps"] = ADAFACTOR_G2P_STEPS
    res = {"gate": adafactor_gate(torch, model_cfg, data_cfg, gpu_line),
           "resume": adafactor_resume(torch, gpu_line),
           "zoo": loss_zoo_gate(torch, gpu_line),
           "mix": mixstyle_prenet_gate(torch, gpu_line)}

    st = {"ref": None, "steps": [], "losses": [], "trainer": None}
    real_step = Trainer.training_step

    def step(self, batch):
        if st["ref"] is None:
            st["ref"] = [p.detach().clone() for p in self.model.parameters()]
        out, ms = _timed_ms(torch, lambda: real_step(self, batch))
        st["steps"].append((ms, tuple(batch.mel.shape)))
        return out

    def callback(trainer, last):
        st["trainer"] = trainer
        vals = {k: float(v) for k, v in last.items()}
        st["losses"].append(vals)
        check(all(np.isfinite(v) for v in vals.values()), f"adafactor_zoo: loss {vals}")
        changed = any(not torch.equal(p, r) for p, r in zip(trainer.model.parameters(),
                                                            st["ref"]))
        check(changed == (trainer.global_step >= 2),
              f"adafactor_zoo: weights {'changed' if changed else 'unchanged'} after step "
              f"{trainer.global_step} (lr 0 at count 0)")

    saved_env = os.environ.get("DATAPIPE_PROFILING")
    os.environ["DATAPIPE_PROFILING"] = "1"
    saver = experiment_saver(model_cfg, data_cfg, tmp)
    Trainer.training_step = step
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with experiment_log(saver):
            expr = TT.train(model_cfg, data_cfg, saver, device="cuda", callbacks=[callback])
        t_fit = time.perf_counter() - t0
    finally:
        Trainer.training_step = real_step
        if saved_env is None:
            os.environ.pop("DATAPIPE_PROFILING", None)
        else:
            os.environ["DATAPIPE_PROFILING"] = saved_env
    peak = torch.cuda.max_memory_allocated()
    opt = st["trainer"].optimizer
    check(isinstance(opt.base, Adafactor), "adafactor_zoo: train_tts did not train with adafactor")
    params = list(st["trainer"].model.parameters())
    adam_bytes = 2 * sum(p.numel() * p.element_size() for p in params)
    state_bytes = _state_bytes(opt)
    factored = sum("v_row" in s for s in opt.base.state.values())
    summary = profiler_summary(Path(expr) / "experiment.log")
    pipe = list(data_cfg["preproc"]["pipe"])
    n = summary.get("datapipe.sample", (0, 0.0))[0]
    workers = int(model_cfg["data_loaders"]["n_workers"])
    counts = {h: summary.get(f"handler.{h}", (0, 0.0))[0] for h in pipe}
    ms = [s[0] for s in st["steps"]]
    print(f"[adafactor_zoo] train_tts with adafactor ({model_yml.name} via -c, default preset, "
          f"B{ADAFACTOR_BATCH}): {ADAFACTOR_STEPS} steps in {t_fit:.1f} s with set-up; ms a "
          f"step " + " ".join(f"{v:.1f}" for v in ms) + f" (median of 2.. "
          f"{statistics.median(ms[1:]):.1f}); mel {st['steps'][-1][1]}; losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in st["losses"][-1].items())
          + f"; peak device memory {peak / 2**30:.2f} GiB; optimizer state "
          f"{state_bytes / 2**20:.2f} MiB against Adam's {adam_bytes / 2**20:.2f} MiB "
          f"({state_bytes / adam_bytes:.4f}); {factored} of {len(params)} leaves factored; "
          f"DATAPIPE_PROFILING: {n} samples through the {len(pipe)} handlers, "
          + ", ".join(f"{h} {counts[h]} x {summary.get(f'handler.{h}', (0, 0.0))[1]:.2f} ms"
                      for h in pipe) + f" ({gpu_line})", flush=True)
    check(n >= ADAFACTOR_BATCH * ADAFACTOR_STEPS
          and all(n <= c <= n + workers for c in counts.values()),
          f"adafactor_zoo: the profiler summary's handler counts {counts} against {n} samples "
          f"(at most one more a worker, in flight when the loader stopped)")
    check(state_bytes < adam_bytes / 2, "adafactor_zoo: the state is not smaller than Adam's")

    # the run's checkpoint pruned, then served through the eval interfaces (f32)
    ckpt = ExperimentSaver.get_last_checkpoint(expr)
    check(ckpt is not None and ckpt.name == f"step_{ADAFACTOR_STEPS:09d}",
          f"adafactor_zoo: last checkpoint {ckpt}")
    pruned = prune_checkpoint(ckpt, tmp / "pruned")

    def size(p: Path) -> int:
        return sum(f.stat().st_size for f in p.rglob("*") if f.is_file())

    check(size(pruned) < size(ckpt), "adafactor_zoo: the pruned checkpoint is not smaller")
    check(not (pruned / "opt.pt").exists(), "adafactor_zoo: the pruned checkpoint has opt.pt")
    _, voc_params = serving.flagship_params()
    vi = VocoderEvaluationInterface(seeded_vocoder(torch, voc_params).to("cuda"))
    served = {}
    noise = None
    for label, path in (("pruned", pruned), ("full", ckpt)):
        tree, payload = ExperimentSaver.load_checkpoint(path)
        ti = TTSEvaluationInterface.from_checkpoint(tree, payload, ckpt_path=ckpt,
                                                    device="cuda")
        ctx = ti.prepare_embeddings(ti.create_context("EN", ti.get_speakers()[0]))
        opts = TTSOptions(t_out=T_FRAMES)
        if noise is None:
            inputs = ti.prepare_batch(list(ADAFACTOR_SENTENCES), ctx, opts)
            noise = torch.randn(ti.model.noise_shape(inputs, T_FRAMES), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(0)
                                ) * ti.model.decoder.temperature
        if label == "pruned":
            reset_counts()
        served[label] = tts_request(torch, ti, vi, list(ADAFACTOR_SENTENCES), ctx, opts,
                                    noise=noise)
        if label == "pruned":
            request_counts = read_counts()
            with plain_versions():
                plain = tts_request(torch, ti, vi, list(ADAFACTOR_SENTENCES), ctx, opts,
                                    noise=noise)
    check(request_counts == EXPECTED_LAUNCHES,
          f"adafactor_zoo: the pruned checkpoint's request launched {request_counts}")
    wave, ref = served["pruned"]["wave"], plain["wave"]
    check(wave.shape == ref.shape and bool(np.isfinite(wave).all()),
          f"adafactor_zoo: waveform {wave.shape} against plain {ref.shape}")
    wav_err = float(np.abs(wave - ref).max())
    wav_lim = TOL_F32_REL * float(np.abs(ref).max())
    same = bool(np.array_equal(wave, served["full"]["wave"]))
    print(f"[adafactor_zoo] {ckpt.name} pruned ({size(ckpt) / 2**20:.2f} -> "
          f"{size(pruned) / 2**20:.2f} MiB on disk) and served, f32: {len(ADAFACTOR_SENTENCES)} "
          f"sentences, frames {served['pruned']['lens']}, {len(wave) / SR:.3f} s; launches "
          f"{request_counts}; kernels vs plain wave max_abs_err {wav_err:.3g} (tol "
          f"{wav_lim:.3g}); the full checkpoint's waveform {'equal' if same else 'DIFFERS'} "
          f"({served['pruned']['ms']['total']:.1f} ms the request; {gpu_line})", flush=True)
    check(wav_err <= wav_lim, "adafactor_zoo: the served waveform, kernels vs plain")
    check(same, "adafactor_zoo: the pruned checkpoint serves another waveform than the full")
    del vi, ti, st["trainer"]
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[adafactor_zoo] phase wall time {phase_s:.1f} s ({gpu_line})", flush=True)
    res.update(launches=request_counts, phase_s=phase_s, step_ms=statistics.median(ms[1:]),
               peak=peak, state_bytes=state_bytes, adam_bytes=adam_bytes, factored=factored)
    return res


# -- profile (opt-in) ----------------------------------------------------------------

# device kernels by family, matched on the kernel's name, first match wins
# (attention: tc::attn_fwd_kernel, bf16; mma::attn_fwd_tf32_kernel, f32 and dh > 128)
FAMILIES = (("fused_attention", ("attn_fwd",)), ("anti_alias", ("aa_kernel",)),
            ("convolution", ("conv", "cudnn", "implicit", "winograd", "fft")),
            ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "wgmma", "nvjet")),
            ("elementwise and norms", ("elementwise", "layer_norm", "catarray", "reduce")))


# rows of the profile that are host operators or runtime calls, not device work: they
# repeat the device time of the kernels they launch and would count it twice
HOST_ROWS = ("aten::", "cuda", "cuLaunch")


def _self_device_us(event) -> float:
    dev = getattr(event, "self_device_time_total", None)  # older torch: self_cuda_time_total
    return event.self_cuda_time_total if dev is None else dev


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in FAMILIES if any(k in low for k in keys)), "other")


def phase_profile(torch, gpu_line: str) -> None:
    """For each serving program (flagship, toy): one batch split into its two
    models (host clock around each, synchronised), then one batch under
    ``torch.profiler``: device time by kernel family, the device's busy share
    and the slowest convolutions by shape. The full per-kernel tables go to
    ``profile_<program>.txt`` in the run's git-ignored output directory."""
    from speechflow_torch import serving

    for label, build, features in (("flagship", serving.build_flagship, True),
                                   ("toy", serving.build_toy, False)):
        am, vm = build(device="cuda", dtype=torch.bfloat16, seed=0)
        profile_program(torch, label, am, vm, features, gpu_line)
        del am, vm
        torch.cuda.empty_cache()


def profile_program(torch, label: str, am, vm, features: bool, gpu_line: str) -> None:
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechflow_torch import serving

    inputs = serving.bench_inputs(np.random.default_rng(2), batch=BATCH, features=features)
    gen = torch.Generator(device="cuda").manual_seed(2)
    serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)  # warm-up
    with torch.inference_mode():
        x = inputs.to("cuda", torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = am.inference(x, t_out=T_FRAMES, generator=gen).spectrogram[-1]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vm.from_features(mel)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    print(f"[profile {label}] acoustic model {1e3 * (t1 - t0):.1f} ms, vocoder "
          f"{1e3 * (t2 - t1):.1f} ms per batch of {BATCH} (bf16, {gpu_line})", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        serving.synthesize(am, vm, inputs, t_out=T_FRAMES, generator=gen)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows, queue_full = [], None
    for e in prof.key_averages():
        dev = _self_device_us(e)
        if e.key == "Command Buffer Full":  # the host waiting on a full launch queue
            queue_full = (e.count, dev)
        elif (e.device_type == DeviceType.CUDA and dev > 0
              and not e.key.startswith(HOST_ROWS)):
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, "the profiler recorded no device time")
    if queue_full:
        print(f"[profile {label}] launch queue full {queue_full[0]} times, "
              f"{queue_full[1] / 1e3:.1f} ms in all", flush=True)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"profile_{label}.txt", "w") as f:
        f.write(f"# one {label} batch (B={BATCH}, bf16), {gpu_line}; wall {wall_us:.0f} us\n")
        f.write("# self device us, calls, share, family, name\n")
        for dev, count, key in rows:
            f.write(f"{dev:.0f}\t{count}\t{dev / busy:.4f}\t{_family(key)}\t{key}\n")
    by_family = {}
    for dev, _, key in rows:
        by_family[_family(key)] = by_family.get(_family(key), 0.0) + dev
    print(f"[profile {label}] device busy {busy / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
          f"({busy / wall_us:.3f} busy share, the profiler on)", flush=True)
    for fam, dev in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile {label}]   {fam}: {dev / 1e3:.1f} ms ({dev / busy:.3f} of device time)")
    for dev, count, key in rows[:12]:
        print(f"[profile {label}]   {dev / 1e3:9.2f} ms {count:6d}x  {key[:90]}")
    # which layers the convolution time belongs to: (input, weight) shapes, slowest first
    convs = sorted(((_self_device_us(e), e.count, e.input_shapes[:2])
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.key == "aten::cudnn_convolution"), reverse=True)
    for dev, count, shapes in convs[:8]:
        print(f"[profile {label}]   conv {dev / 1e3:9.2f} ms {count:4d}x  input, weight {shapes}")


# -- main --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,slice,toy,interface,tts_interface,xtts,bundle,"
                            "train,tts_train,xtts_train,prosody_train,conditioned,jax_ckpt,"
                            "vocoder_model_train,tts_forward_train,jax_resume,tts_options,"
                            "e2e_train,vocoder_recipes,aligner,aux_models,vocoder_cpc,data_prep,"
                            "annotator,ddp,adafactor_zoo",
                    help="comma-separated subset of build,kernels,slice,toy,interface,"
                         "tts_interface,xtts,bundle,train,tts_train,xtts_train,prosody_train,"
                         "conditioned,jax_ckpt,vocoder_model_train,tts_forward_train,"
                         "jax_resume,tts_options,e2e_train,vocoder_recipes,aligner,aux_models,"
                         "vocoder_cpc,data_prep,annotator,ddp,adafactor_zoo,profile "
                         "(the last is not in the default run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    # a run past its deadline dumps every thread's stack and exits non-zero
    faulthandler.dump_traceback_later(SMOKE_DEADLINE_S, exit=True)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "speechflow_torch" / "csrc").is_dir():
        print(f"chip_smoke: no speechflow_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    try:
        return run(torch, phases)
    finally:
        if "dir" in _WORK:
            shutil.rmtree(_WORK["dir"], ignore_errors=True)


def phase_time(label: str, t0: float) -> float:
    """Print a phase's wall time; return the clock for the next phase."""
    now = time.perf_counter()
    print(f"[time] {label} {now - t0:.1f} s", flush=True)
    return now


def start_worker_server() -> None:
    """Start the data workers' forkserver now, so that it imports torch and the data
    modules while the kernels build (``concurrency.context``)."""
    from multiprocessing import forkserver

    from speechflow_torch.concurrency.context import worker_context

    if worker_context().get_start_method() == "forkserver":
        forkserver.ensure_running()


def run(torch, phases: set) -> int:
    start = t0 = time.perf_counter()
    gpu_line = phase_gpu()
    records = {}
    start_worker_server()
    phase_build()
    t0 = phase_time("build", t0)
    if "kernels" in phases:
        records = phase_kernels(torch)
        t0 = phase_time("kernels", t0)
    # each serving path with the kernels it must launch
    paths = (("slice", phase_slice, tuple(EXPECTED_LAUNCHES)),
             ("toy", phase_toy, ("fused_attention",)),
             ("interface", phase_interface, tuple(HEAD_LAUNCHES)),
             ("tts_interface", phase_tts_interface, tuple(EXPECTED_LAUNCHES)),
             ("xtts", phase_xtts, ("fused_attention",)),
             ("bundle", phase_bundle, tuple(EXPECTED_LAUNCHES)),
             ("train", phase_train, tuple(HEAD_LAUNCHES)),
             ("tts_train", phase_tts_train, tuple(EXPECTED_LAUNCHES)),
             ("xtts_train", phase_xtts_train, ("fused_attention",)),
             ("prosody_train", phase_prosody_train, ("fused_attention",)),
             ("conditioned", phase_conditioned, tuple(EXPECTED_LAUNCHES)),
             ("jax_ckpt", phase_jax_ckpt, ("fused_attention", "anti_alias_snake")),
             ("vocoder_model_train", phase_vocoder_model_train, ()),
             ("tts_forward_train", phase_tts_forward_train, tuple(HEAD_LAUNCHES)),
             ("jax_resume", phase_jax_resume, ()),
             ("tts_options", phase_tts_options, ("fused_attention",)),
             ("e2e_train", phase_e2e_train, ("fused_attention", "anti_alias_snake")),
             ("vocoder_recipes", phase_vocoder_recipes, ()),
             ("aligner", phase_aligner, ("fused_attention",)),
             ("aux_models", phase_aux_models, tuple(EXPECTED_LAUNCHES)),
             ("vocoder_cpc", phase_vocoder_cpc, tuple(HEAD_LAUNCHES)),
             ("data_prep", phase_data_prep, ("fused_attention", "anti_alias_snake")),
             ("annotator", phase_annotator, ("fused_attention",)),
             ("ddp", phase_ddp, tuple(EXPECTED_LAUNCHES)),
             ("adafactor_zoo", phase_adafactor_zoo, tuple(EXPECTED_LAUNCHES)))
    by_path = {}
    for label, phase, kernels_of_path in paths:
        if label not in phases:
            continue
        out = phase(torch, gpu_line)
        t0 = phase_time(label, t0)
        counts = out["launches"]
        check(all(counts[k] > 0 for k in kernels_of_path),
              f"{label}: a kernel of the path was never launched: {counts}")
        by_path[label] = counts
        # the training forward and VJP times: the anti-alias entries' (train), attention's
        # (xtts_train)
        for name, times in out.get("times", {}).items():
            records.setdefault(name, {}).update(times)
    for name in KERNEL_META:
        if by_path:
            records.setdefault(name, {})["launches"] = sum(c[name] for c in by_path.values())
            records[name]["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    if "profile" in phases:
        phase_profile(torch, gpu_line)
        t0 = phase_time("profile", t0)
    print(f"[time] total {time.perf_counter() - start:.1f} s", flush=True)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = records.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": r.get("launches"), "max_abs_err": r.get("max_abs_err"),
                        "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                        "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                        "library_ms": r.get("library_ms"),
                        **{k: v for k, v in r.items()
                           if k.endswith("_by_path")
                           or k in ("train_fwd_ms", "train_fwd_err", "vjp_ms", "vjp_plain_ms",
                                     "vjp_err")}})
    print(json.dumps({"kernels": kernels}))
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
