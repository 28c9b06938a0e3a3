#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ezaudio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # build + torch.profiler breakdown of
                                     # the main path (5 steps), staged and
                                     # fused, f32 and bf16, no checks

Phases, each fatal on failure:
  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  2. build every CUDA kernel of the port from ``ezaudio_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, f32 and bf16, TF32 and cuBLAS's reduced-precision bf16
     reductions off: max error against the stated tolerance, the median
     time of kernel, plain version and (attention) SDPA as a yardstick;
  4. the main path: ``EzAudio("s3_l", device="cuda")`` on seeded random
     weights, f32, ``generate_audio`` at its defaults (10 s, 100 DDIM steps,
     CFG 5, rescale 0.75, eta 1) for 1 and for 4 prompts; the kernels'
     launch counters must show both kernels on that path;
  5. the whole path on the card (kernels) against the CPU (plain versions)
     on the same weights and initial latents: s3_l at full width, depth 2,
     1 s, 3 steps, eta 0;
  6. editing on the same EzAudio: ``editing_audio`` at its defaults
     (CFG 3.5, rescale 0, 100 steps, eta 1) on a seeded 10 s clip, mask
     [4 s, 7 s), boundary 2 s (clamped to half the mask: a 6 s window);
  7. long generation: ``generate_long(length=20, window=10, overlap=2)``,
     one generate and two outpainting edits, 10 DDIM steps each (``CUT_*``);
  8. the fast samplers, 10 s, 1 prompt: DPM-Solver++ at 25 steps; DPM +
     ``layer_cache=(2, 2)`` + ``guidance_interval`` + ``cfg_refresh=2`` at 25;
     DDIM + ``layer_cache=(2, 2)`` at 100; ``sampler='distilled'`` at 8;
  9. card against CPU on the same weights and draws, s3_l at full width,
     depth 4 (layer caching needs 1 <= k < depth/2): ``editing_audio`` at
     eta 0, and DPM + ``layer_cache`` + ``guidance_interval`` + ``cfg_refresh``;
 10. ``fused=True`` at phase 4's recipe for 1 and 4 prompts on the same
     EzAudio: the first call (eager warm-up, CUDA graph capture and
     instantiation, one replay), then one replay; the waveform must equal
     phase 4's within FUSED_TOL and each replay must launch the kernels as
     often as a staged call does;
 11. ``quant="int8"``, 1 prompt, 25 steps, staged and fused: every
     (M, K, N) of the int8 products the DiT gave, ``int8_dot`` on the card
     against its plain version on the CPU (bit-equal), the staged launches
     those of an f32 call, fused int8 equal to staged int8;
 12. a ``GenerationServer`` (DPM ``CUT_SERVED_STEPS`` steps, batches of up to 4, length
     buckets 5 s and 10 s): four 10 s and two 4 s requests and phase 6's
     edit; fewer generate batches than generate requests, two served
     waveforms against their solo calls and the edit against the direct
     call; then the same requests twice with ``fused=True`` (the first pass
     captures a graph per signature, the second replays them), each equal
     to the staged server's waveforms;
 13. the energy ControlNet: ``EzAudioControlNet("energy", device="cuda")``
     on seeded random weights (a fresh base EzAudio; the ControlNet's 12
     in-blocks copied from it), ``generate_audio`` on a 10 s clip in 0.5 s
     bursts at its defaults (DDIM 50 steps, CFG 3.5, eta 1), with DPM 25,
     with ``quant="int8"`` (DDIM ``CUT_INT8_STEPS``), and with DPM at
     conditioning scale 0, which must differ from scale 1;
 14. the ControlNet path on the card against the CPU on the same weights
     and draws: energy config at full width, depth 4, a 1 s clip, 3 steps,
     eta 0;
 15. a ``GenerationServer(cn.base, controlnet=cn)`` (DPM ``CUT_SERVED_STEPS``): two 10 s
     generate requests and one ControlNet request; one ControlNet request
     counted and its waveform equal to the direct call within FUSED_TOL;
 16. s3_l in bf16: ``EzAudio("s3_l", dtype=torch.bfloat16)`` on phase 4's
     seeded weights, ``generate_audio`` at its defaults for 1 and 4 prompts
     and ``fused=True`` for 1 (first call and one replay, equal to staged
     within FUSED_TOL); every launch a bf16 launch; the distance and
     correlation of each waveform to phase 4's f32 one are printed, not
     checked;
 17. bf16 on the card against bf16 on the CPU (the plain versions), the same
     weights and initial latents: s3_l at full width, depth 4, 1 s, 3 DDIM
     steps, eta 0: no farther from the CPU's bf16 output than
     BF16_REF_FACTOR times the CPU's bf16-to-f32 distance, and correlated
     above BF16_PIPE_MIN_CORR;
 18. the checkpoint round trip: phase 13's f32 models written in the
     reference formats to a temporary directory (DiT and ControlNet
     ``{"model": ...}``, the VAE ``{"state_dict": {"autoencoder." ...}}``
     with ``weight_g``/``weight_v``, T5 in HF names), loaded by
     ``EzAudio(ckpt_path=, vae_path=, t5_path=)`` and
     ``EzAudioControlNet(controlnet_path=)``: a short f32 generate and
     ControlNet call equal the writer's within CKPT_REL_TOL of the range;
 19. s3_xl in bf16 at full width and depth (embed 1152, depth 28,
     FLAN-T5-XL): ``generate_audio`` at its defaults for 1 prompt, every
     launch a bf16 launch;
 20. CLAP reranking on phase 4's EzAudio: ``CLAPScorer`` at the
     ``laion/clap-htsat-unfused`` widths (HTSAT embed 96, depths 2/2/6/2;
     RoBERTa-base; projection 512) on seeded weights,
     ``generate_audio_reranked`` on 1 prompt with 4 candidates at the
     reference recipe but ``CUT_RERANK_STEPS`` DDIM steps (seeded CLAP ids
     padded to 32, some rows shorter),
     the scoring timed alone; the candidates scored again by the CPU scorer:
     embeddings within CLAP_EMBED_ATOL, the same choice unless the CPU's
     top two are within CLAP_TIE;
 21. a ``GenerationServer(ez, clap_scorer=)`` (DPM ``CUT_SERVED_STEPS``, ``fused=True`` in its
     recipe): one ``submit_reranked`` (run staged) and one plain request;
     the rerank equal to the direct call by phase 12's rule, one rerank
     request counted;
 22. ``Conditioner('vc', sr=24000)`` at ContentVec-base widths (conv 7 x
     512, 12 layers at 768) on a seeded 10 s clip: (1, 500, 768), one frame
     per latent frame; wall (median of 5) and peak; the CPU extractor on the
     same weights within VC_REL_TOL of its range;
 23. (after phase 3) the kernels' gradients at the train step's shapes
     (batch 8, f32): kernel 1's autograd gradients through its wrapper
     against the plain twin's, s3_l self-attention and T5-masked
     cross-attention and against SDPA's, with the backward's time (the
     plain recompute), its bound and SDPA's forward and backward; kernel
     2's nine gradients at the DiT step's third encoder block and the
     codec step's first, with the backward's time and bound; each
     output's kernel ``grad_fn``;
 24. training s3_l at full width: ``train_cli.main`` on 16 seeded 10 s,
     24 kHz clips and a CSV in a temporary directory, batch 8, 6 steps,
     warmup 2, CFG dropout 0.1, ``use_checkpoint`` (full remat); every
     step exactly 100 attention launches (50 forward, 50 recomputed) and
     12 ResidualUnit launches (the batch's encode), all f32; per-step
     wall (median of steps 2-6), samples/s, audio-s trained per s, model
     TFLOP/s (``train_flops``), peak memory and the losses printed; then
     the trainer is deleted (memory checked back), the step-6 checkpoint
     removed, and the restart from step 4 must give steps 5-6's losses
     within RESUME_REL_TOL;
 25. one train step on the card under each remat policy (full, dots,
     off) against one on the CPU: s3_l widths at depth 2, the same
     weights, batch (2) and injected draws: loss, grad norm, every
     gradient and every updated parameter within the limits of
     ``train_step_agreement``, the attention launches each policy
     implies, and a non-zero gradient on the q, k and v projections of
     every attention (ROADMAP F11);
 28. (after phase 25) bf16 mixed-precision training: kernel 1's bf16
     autograd gradients at the train shapes against SDPA's bf16 ones (no
     farther from the f32 gradients than BF16_REF_FACTOR times SDPA's,
     correlated above BF16_ATTN_GRAD_CORR), the bf16 backward timed beside
     SDPA's bf16 forward and backward; ``train_cli.main --dtype
     bfloat16`` on phase 24's data and recipe (every step 100 attention and
     12 ResidualUnit launches, all bf16; f32 parameters and moments; the
     restart from step 4 equal), its step wall, samples/s, model TFLOP/s
     against the bf16 peak and peak memory printed beside phase 24's; then
     one bf16 step at depth 2 under AdamW, AdamW with a bf16 first moment
     and Adafactor, card against CPU by the statistical rule (``BF16_*``);
 26. ControlNet fine-tuning of EzAudio-L-Energy: the frozen s3_l base and
     the ControlNet's trainable subset, batch 8 × 10 s of seeded latents,
     energy conditions of seeded clips, T5 on seeded captions, remat on,
     f32, 4 steps: step wall (median of steps 2-4), samples/s, peak; the
     base's and the frozen ControlNet tensors' bytes unchanged, every
     trainable tensor moved, every zero block's gradient non-zero (F6),
     ``controlnet_train_launches`` a step; then one step at depth 2, card
     against CPU by ``train_step_agreement``;
 27. progressive distillation on a fresh f32 s3_l: one stage (the student,
     a deep copy, 8 steps on the teacher's 16; CFG 5 folded in), batch 4 ×
     10 s, 4 steps: one student DDIM step with v* lands on the teacher's
     two-step target within DISTILL_LAND_TOL, the teacher's bytes
     unchanged, 200 launches a step; the student served by
     ``generate_audio(sampler='distilled')`` for 10 s (8 × 50 attention
     and 12 ResidualUnit launches); then one step at depth 2, card against
     CPU;
 29. on the same model: one ``flow_matching_loss`` train step (batch 4) and
     a 10-step Heun ``flow_sample`` with CFG 5 and rescale 0.75, decoded;
     ``eval_udit`` in MAE mode on one seeded clip (50 DDIM steps, the
     encode and the decode); ``prepare_embeddings`` on phase 24's
     manifest, then one ``train_cli`` step from those files;
 30. the codecs, each model on seeded weights (``codec_trainer.init_codec_``):
     (a) the VAE codec trainer at ``vae.json``'s widths with live weight
     norm, the discriminator at its defaults (24 kHz), batch 8 x 12 000
     samples, 4 steps: exactly 24 f32 kernel-2 launches a step at shapes
     phase 3 holds, every generator and discriminator tensor moved, a
     non-zero gradient on every ``weight_g`` and ``weight_v``; step wall
     (median of steps 2-4), samples/s, peak, the losses; then one step at
     cut widths (c_mults 1/2, strides 2/4), card against CPU and the CPU's
     float64 step (``codec_step_agreement``); (b) DAC at the JAX ``DAC()``
     defaults (descript's 44.1 kHz model): a 10 s clip card against CPU by
     the near-tie rule (``near_tie_codes``), the ``.dac`` round trip on the
     card (codes equal to the forward's, loudness restored), three train
     steps at batch 4 x 0.5 s with quantizer dropout 0.5; (c) EnCodec at
     the JAX ``Encodec()`` defaults, 10 s card against CPU by the same
     rule; (d) the facade: ``'stable_vae'``, ``'dac'`` and ``'encodec'``
     with ``quantization_first`` True and False (equal waveforms), DAC's
     chunked path on 10 s; (e) PQMF (16 bands) and db4 wavelet round trips
     card against CPU;
 31. the UDiT architecture switches at s3_l width (``VARIANT_SWITCHES``:
     the reference golden's switch set, concat context of 100 T5 tokens,
     so every block runs one masked self-attention over 600 tokens): (a)
     ``EzAudio(config=variant_config())`` in f32 at the reference recipe
     (``VARIANT_STEPS`` DDIM steps), 1 prompt and 4, then ``fused=True`` (a first call and one replay,
     equal to staged within FUSED_TOL); (b) the same in bf16, every launch bf16;
     (c) ``TOKEN_SWITCHES`` (a time token: 601 tokens, dual RoPE, gated
     snake); kernel 1 25 x 50 launches a call, kernel 2 12 a decode, every
     attention shape among phase 3's; (d) card against CPU at depth 2:
     config (a)'s ``generate_audio``, each ``SWITCH_CASES`` UDiT (2-D
     input, ``cls_dim``, the conv PE, every time fusion, RoPE mode and
     activation), ``DiTControlNet`` with concat context, ``CFGModel`` and
     ``ConcatModel``, and one span-masked train step of config (a) (kernel
     1's masked self-attention backward);
 32. the port's demos and audio toolkit (``toolkit_paths``): (a)
     ``python -m ezaudio_tpu_torch.demo t2a`` and ``... controlnet --ref``
     (a seeded 10 s burst clip) at their defaults through ``demo.main``,
     each building its model (s3_l; energy) on the card by default: 5 000
     / 12 and 3 700 / 12 launches; (b) ``AudioSignal`` on the t2a wav:
     load, resample, loudness, normalize, ``stft``/``mel_spectrogram``/
     ``mfcc`` card against CPU (``SIGNAL_*``), the write/load round trip;
     (c) an ``AudioDataset`` over 16 seeded 10 s wavs and a ``create_csv``
     manifest with a ``Compose`` of every transform (``toolkit_compose``),
     batches of 8 on the card (wall per batch) against the CPU (``DATA_*``),
     ``istft`` twice on the card bit-equal; (d) ``stoi``, ``pesq`` and
     ``visqol_nsim`` of the t2a clip against its band-limited and MNRU
     versions, in range; (e) ``WhisperTranscriber`` at whisper-base width
     on seeded weights: features, embeddings and 64-token ``transcribe``
     at batch 1 and 4 (median of 3, peak), card against CPU
     (``WHISPER_*``, ids by the near-tie rule); none of it imports pandas,
     matplotlib, IPython or transformers;
 33. non-wav audio, a world of one, the ring (``nonwav_paths``,
     ``world_one_paths``, ``ring_math``): (a) the codec bridge and the
     native loader built with ``g++`` into the build directory (whether
     libav and ``g++`` were found is printed; without libav the native
     loader runs alone), phase 4's clip through flac (bit-exact), mp3 and
     ogg (SNR, ``MP3_*``/``OGG_*``) and ``AudioSignal.load`` of the mp3,
     ``EACaps(use_native=True)`` over 16 seeded 10 s wavs in batches of 8
     (one ``load_batch`` call each) into the VAE encode on the card (12
     launches of kernel 2 a batch), card against CPU; (b) a world of one on
     NCCL: ``EzAudio("s3_l", mesh=make_mesh())`` at 1 prompt and
     ``CUT_MESH_STEPS`` DDIM steps equal to the mesh-less EzAudio
     (``MESH_TOL``), one s3_l f32 train step (batch 2) of
     ``Trainer.create(mesh=make_mesh())`` and of an FSDP2 (HSDP) wrapped
     trainer against the plain step by phase 25's limits, then the bf16
     mixed-precision step of the HSDP-wrapped trainer (FSDP2 gathering in
     bf16) against the plain bf16 step by phase 28's statistical rule
     (``BF16_*``), both walls and kernel 1's bf16 launches logged; one
     ``DiTControlNet`` forward over a base without text (``context_dim``
     None) at the energy model's widths, depth 4, card (kernel 1) against
     the CPU (its plain twin), at scale 1 and 0 (``controlnet_nocontext_path``); (c) the ring's
     per-hop math at sp = 4 in one process at s3_l and s3_xl
     self-attention, f32 and bf16, with and without a key mask: forward
     against kernel 1, backward against SDPA, timed beside kernel 1;
 34. the quality harnesses (``ezaudio_tpu_torch/validation/``):
     (a) ``quality_validate`` at its widths (depth 4, dim 128, 4 heads x
     32, 4 text tokens), ``HARNESS_TOY_STEPS`` train steps, then DDIM-25
     and DPM-10 rows at ``HARNESS_TOY_EVAL`` samples, scored; (b)
     ``quality_validate_mid`` at s3_l's widths, depth ``HARNESS_MID_DEPTH``:
     16 + 8 seeded 10 s clips through the VAE encode (12 launches a batch)
     and the sanity gate (its accuracy printed), ``HARNESS_FIT_STEPS``
     steps of the VAE fit (batch 4 x 1 s, 24 launches a step),
     ``HARNESS_TEACHER_STEPS`` teacher steps, DDIM-10 and DPM-10 rows at 8
     samples with the CLAP columns (a decode of 12 launches each); (c) card
     against CPU: one encode batch (``HARNESS_ENCODE_REL_TOL``) and a
     DPM-10 row at depth 2 (``HARNESS_ROW_REL_TOL``);
 35. the mid product harnesses (``validation/{mid_common,distill_serve_mid,
     quality_edit_controlnet_mid,verify_checkpoints}.py``) on EzAudio-Mid
     (dim 512, 8 heads x 64, ``vae.json``'s VAE, the tiny T5 of 8 tokens),
     depth ``PRODUCT_DEPTH``, every cache in a fresh temporary root: (a)
     16 + 8 seeded 10 s clips encoded and gated, ``PRODUCT_FIT_STEPS`` VAE-fit
     steps, ``PRODUCT_TEACHER_STEPS`` teacher steps, 2 + 2 distillation
     steps (CFG folded in), the student saved and reloaded (its tensors
     bit-equal), 4 prompts served at batch 4, the teacher at DDIM-10 + CFG
     and the student at 4 calls, scored; the served student's waveform
     against a direct ``generate_audio(sampler='distilled')``; (b) the
     editing and ControlNet harness on (a)'s cached VAE, data and teacher:
     2 class-changing edits with and without crossfade and 2 same-class
     edits at 10 steps, the energy ControlNet from zero projections (its
     output at scale 1 equal to scale 0), 3 fine-tune steps (then unequal),
     one ControlNet and one t2a sample at 10 steps, Pearson r; (c) card
     against CPU: the data encode and ``roundtrip_latents`` of 4 x 1 s
     clips, and ``verify_checkpoints`` on reference-format files of (b)'s
     models (counts equal, SI-SDR and the t-delta within ``PRODUCT_*``);
     every path's launches as ``product_want`` counts, every attention
     shape among phase 3's;
 36. the load harnesses (``validation/{serving_bench,fused_ab}.py``) through
     their mains on their scripts' model, s3_xl in bf16 with the tiny T5:
     (a) ``serving_bench`` at the reference recipe cut to ``LOAD_STEPS``
     DDIM steps, ``--mixed`` (5 s and 10 s requests),
     ``LOAD_RATE`` req/s for ``LOAD_WINDOW_S`` s, batches of up to
     ``LOAD_MAX_BATCH``: every request served, the slot fill in (0, 1];
     (b) ``fused_ab`` at batch ``LOAD_AB_BATCH``, both recipes cut likewise:
     each fused waveform equal to the staged one; every staged call's and
     fused replay's launches as its recipe and batch imply
     (``load_call_launches``), all bf16;
 37. the launches of each path, a ``{"kernels": [...]}`` line (launches
     summed over the paths of phases 4-8, 10-13, 15, 16, 19-21, 24, 26-36),
     the card's name and power limit, and last ``{"ok": true,
     "device": {...}}``.

Phase 3 also holds kernel 1 at phase 31's masked self-attention shapes
(phase 23 its backward there, batch 8), at phase 34's (4 text tokens, head
dim 32) and at phase 35's (the tiny T5's 8 padded tokens, the served CFG
pair of 32, an edit window's 280 frames, ``verify_dit``'s 100 unmasked
context tokens), at phase 36's (s3_xl's 5 s bucket), kernel 2 at phase
34's VAE fit, at phase 35's edit window and at phase 36's 5 s decode in
bf16; phase 30 (a) also restarts the codec step from a checkpoint,
bit-equal to the straight run (ROADMAP F14).

Every path of phases 4, 6-8, 11-13, 15, 16, 19-21, 24, 26-36 is driven with the launch
counters set to 0 just before it and read just after, and must launch each
kernel exactly as often as its model calls and decodes imply; the bf16
paths count every launch by dtype (``launches_by_dtype``), so a path that
ran a kernel in f32 fails.  A fused call runs as a CUDA graph whose replays
do not pass through the kernels' Python wrappers: its launches are those
its capture recorded, times its replays.  Every ResidualUnit shape and
dtype the paths give the kernel must be among those of phase 3.  Each
model is deleted before the next is built, and the allocated memory must
fall back to within MEM_SLACK_GIB of its value before the build (no
``gc.collect()``); each phase prints its seconds.

It exits non-zero, with no result line, when CUDA is unavailable or the
port's sources are missing.  Bounds use the H100 SXM data-sheet peaks:
3.35 TB/s, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 (tensor cores); an f32
product costs three TF32 products (3xTF32), so f32 work is bounded at
495 / 3 TFLOP/s.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12
# f32 at the f32-accurate tensor-core rate: the kernels compute every f32
# product as three TF32 products (3xTF32, csrc/mma_tf32.cuh), which is as
# accurate as f32 at these tolerances and 2.5x the 67 TFLOP/s of the CUDA
# cores.  One TF32 product is not accurate enough (tests/test_torch_chip_smoke.py).
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# Attention agreement with the plain version.  f32: every element within
# ATTN_F32_ATOL (sums in another order).  bf16: both sides round p to bf16,
# and a p summed in another order now and then lands on the other side of a
# rounding boundary, which moves its row's outputs by one bf16 ulp of p
# (<= 2^-8) times |v|.  So bf16 passes when every element is within
# 2^-8 * max|v| plus one output ulp, and at most BF16_OFF_SHARE of the
# elements are beyond one output ulp (2^-7 |plain| + 1e-5).
# tests/test_torch_chip_smoke.py shows that a kernel that rounds p as the
# plain version does passes, and that one that keeps p in f32, accumulates
# in bf16 or drops a key tile fails.
ATTN_F32_ATOL = 1e-4
BF16_OFF_SHARE = 1e-3
RESUNIT_TOL = 1e-4
PIPE_REL_TOL = 1e-3
PIPE_MIN_CORR = 0.9999
# fused against staged on the card: the same kernels on the same inputs in
# the same order, so equal; the limit leaves room for a library routine
# that chooses another algorithm inside a graph
FUSED_TOL = 1e-5
# bf16 on the card against bf16 on the CPU: the rule of
# tests/test_torch_bf16.py.  The card may be no farther from the CPU's bf16
# output than BF16_REF_FACTOR times the CPU's bf16 distance from its own f32
# output on the same weights and inputs, and correlate above
# BF16_PIPE_MIN_CORR.  Summing in another order alone moves a bf16 output by
# about 5 % of its range here (the CPU with 8 and with 3 threads, PERF.md
# §6), so a fixed share of the range near that spread cannot separate a
# fault from rounding; the kernels' own bf16 functions are held in phase 3.
BF16_REF_FACTOR = 2.0
BF16_PIPE_MIN_CORR = 0.99
# a model loaded from the files written of it: the DiT, T5 and the
# ControlNet load bit for bit; the VAE's weight norm, folded again, rounds
CKPT_REL_TOL = 1e-4
# a deleted model's memory: allocated bytes back within this of their
# value before it was built
MEM_SLACK_GIB = 0.1
# ContentVec features, card against CPU in f32: within this share of the
# CPU output's range
VC_REL_TOL = 1e-4


# Depth cut from earlier card-only paths so that the whole run stays within
# 600 s with phases 32-35 (PERF.md section 4, "cut:"): fused replays
# after the first call (phases 10, 16, 31; 2 before), DDIM steps of the
# int8 calls (phase 11 and, since phase 35, phase 13's; 100 and 50 before)
# and of generate_long's windows (phase 7; 100 before), DPM steps of the
# servers (phases 12, 15, 21; 25, then 10 before phase 34), phase 31 (a)'s
# 1-prompt call run once (3 before), the DDIM steps of phase 31 (a)-(c)'s
# calls (VARIANT_STEPS; 100, then 50 before phase 34) and of phase 20's
# reranked call (100 before phase 35); with phase 33 (b)'s bf16 steps, the
# int8, reranked and generate_long calls and phase 31 (a)-(c) again, 25 ->
# 10, and phase 33 (b)'s generate calls 10 -> 5.  The shapes each kernel
# sees, and every check, are unchanged.
CUT_REPLAYS = 1
CUT_INT8_STEPS = 10
CUT_RERANK_STEPS = 10
CUT_LONG_STEPS = 10
CUT_SERVED_STEPS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median device time of one call of ``fn``, replayed from a CUDA graph
    of ``iters`` calls: no host launch cost (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# (B, H, Lq, Lk, head_dim, key mask); B = 2 is one prompt's CFG pair.
# The key mask: False (none), True (T5 padding: 23 valid keys in even
# rows, all in odd ones), "t5_8" (the tiny T5's 8 tokens: 6 valid in the
# prompts' half of the batch, 1 in the empty prompts') or "concat" (the
# self-attention of a UDiT with
# concat context: Lk - 600 time/class tokens, the 100 context tokens with
# 23 valid in even rows and 1 in odd ones (CFG's empty prompt), 500
# latent frames).
ATTN_CASES = [(2, 16, 500, 500, 64, False),   # s3_l self-attention
              (2, 16, 500, 100, 64, True),    # s3_l cross-attention, T5 padding
              (2, 16, 500, 500, 72, False),   # s3_xl self-attention (head_dim 72)
              (2, 16, 500, 100, 72, True),    # s3_xl cross-attention
              (2, 16, 600, 600, 64, "concat"),   # s3_l width, concat context (phase 31)
              (2, 16, 601, 601, 64, "concat"),   # the same with a time token
              # the quality harnesses (phase 34): 4 text tokens, no key mask;
              # the toy's CFG pair of 32 samples (4 heads x 32), the mid
              # harness's train batch (8 heads x 64), s3_l width's cross
              (64, 4, 64, 64, 32, False), (64, 4, 64, 4, 32, False),
              (16, 8, 500, 500, 64, False), (16, 8, 500, 4, 64, False),
              (16, 16, 500, 4, 64, False),
              # the product harnesses (phase 35 and the default runs): the
              # served teacher's CFG pair at batch 16 and cross-attention to
              # the tiny T5's 8 padded tokens, an edit window of 5.6 s (280
              # frames, CFG pair), verify_dit's 100 unmasked context tokens
              (32, 8, 500, 500, 64, False), (32, 8, 500, 8, 64, "t5_8"),
              (2, 8, 280, 280, 64, False), (2, 8, 280, 8, 64, "t5_8"),
              (2, 8, 500, 100, 64, False),
              # the load harnesses (phase 36): s3_xl's 5 s length bucket
              (2, 16, 250, 250, 72, False), (2, 16, 250, 100, 72, True)]
CONCAT_CONTEXT = 100
# (B, L, C, dilation): the four decoder blocks of one 10 s clip, which are
# also the encoder's blocks of a 10 s window in reverse order.
RESUNIT_CASES = ([(1, 5000, 512, d) for d in (1, 3, 9)]
                 + [(1, 30000, 256, 9), (1, 120000, 128, 9)]
                 + [(1, 240000, 128, d) for d in (1, 3, 9)]
                 + [(2, 1001, 256, 9)]        # many tiles, ragged last tile
                 # encode and decode of phase 6's 6 s window and of phase 7's
                 # last 3 s window: an editing window is padded to 480 samples,
                 # not to the kernel's 64-row tile, so most of these are ragged
                 + [(1, 144000, 128, 1), (1, 72000, 128, 3), (1, 18000, 256, 9),
                    (1, 3000, 512, 1), (1, 36000, 128, 9), (1, 9000, 256, 3),
                    (1, 1500, 512, 9)]
                 # decode of phase 12's 5 s length bucket, two clips
                 + [(2, 2500, 512, 9), (2, 15000, 256, 3), (2, 60000, 128, 1)])
# the VAE encode of a training batch (phases 24 and 28): 8 clips of 10 s
# through the encoder's four blocks, each with dilations 1, 3 and 9
RESUNIT_TRAIN_CASES = [(8, L, C, d)
                       for L, C in ((240000, 128), (120000, 128), (30000, 256), (5000, 512))
                       for d in (1, 3, 9)]
RESUNIT_CASES += RESUNIT_TRAIN_CASES
# the VAE codec step of phase 30: batch 8 of 12 000 samples (vae.json's
# sample_size) through the encoder's four blocks and back through the
# decoder's, which share these (L, C), each at dilations 1, 3 and 9
CODEC_BATCH = 8
CODEC_SAMPLES = 12000
RESUNIT_CODEC_CASES = [(CODEC_BATCH, L, C, d)
                       for L, C in ((12000, 128), (6000, 128), (1500, 256), (250, 512))
                       for d in (1, 3, 9)]
RESUNIT_CASES += RESUNIT_CODEC_CASES
# the quality harness's VAE fit (phase 34): batch 4 of 1 s (24 000 samples)
# through the encoder's blocks and back through the decoder's
RESUNIT_FIT_CASES = [(4, L, C, d)
                     for L, C in ((24000, 128), (12000, 128), (3000, 256), (500, 512))
                     for d in (1, 3, 9)]
RESUNIT_CASES += RESUNIT_FIT_CASES
# the product harness's edits (phase 35): a mask of [3 s, 7 s) with 0.8 s of
# boundary, a 5.6 s window encoded and decoded
RESUNIT_CASES += [(1, 134400, 128, 1), (1, 67200, 128, 3), (1, 16800, 256, 9),
                  (1, 2800, 512, 1)]
# bf16: the decoder blocks of one 10 s clip, the shapes of phases 16 and
# 19, phase 28's bf16 encode of a training batch, and the decode of phase
# 36's 5 s length bucket
RESUNIT_BF16_CASES = ([(1, 5000, 512, d) for d in (1, 3, 9)]
                      + [(1, 30000, 256, 9), (1, 120000, 128, 9)]
                      + [(1, 240000, 128, d) for d in (1, 3, 9)]
                      + RESUNIT_TRAIN_CASES
                      + [(2, 2500, 512, d) for d in (1, 3, 9)]
                      + [(2, 15000, 256, 9), (2, 60000, 128, 9)])
# The bf16 ResidualUnit's snake2 output g, read from the kernel itself:
# with W1 = G_PROBE * I and b1 = 0 it returns round(x + G_PROBE * g), which
# is G_PROBE * g exactly wherever |g| > 3e-9 (x is then below half a bf16
# ulp of it), and within 1e-11 of it elsewhere.
G_PROBE = 2.0 ** 40


def bf16_agreement(got, want, slack=None):
    """``(ok, max_abs_err, share of elements beyond one output ulp)`` of a
    bf16 ``got`` against ``want``: every element within one bf16 ulp of
    ``|want|`` (2^-7 |want| + 1e-5) plus ``slack`` (default: one more
    ulp), and at most BF16_OFF_SHARE of the elements beyond one ulp."""
    diff = (got.float() - want.float()).abs()
    tight = 2.0 ** -7 * want.float().abs() + 1e-5
    loose = tight + (tight if slack is None else slack)
    share = (~(diff <= tight)).float().mean().item()  # NaN counts as off
    ok = bool((diff <= loose).all()) and share <= BF16_OFF_SHARE
    return ok, diff.max().item(), share


def resunit_bf16_agreement(fn, args, dilation, got=None):
    """``(ok, stats)`` of a bf16 ResidualUnit ``fn(*args, dilation)`` (or
    its output ``got``) against ``residual_unit_plain``, a stage at a time.

    g, the snake2 output it feeds the 1x1 product (read with G_PROBE): by
    :func:`bf16_agreement` against the plain g, with the slack of one
    flipped snake1 output h in the conv's window, 2^-7 max|h| max|w7|
    max|snake2'|.  A g summed in another order rounds to the other side
    now and then, in any number of a row's channels (PERF.md §6).
    The output: every element within one bf16 rounding of each side
    (2^-8 (|got| + |want|) + 1e-5: the sides' f32 sums may round into
    different binades) plus what the kernel's own g differences move it
    by, |dg| @ |W1|."""
    import torch

    from ezaudio_tpu_torch.ops.activations import snake_beta_vae
    from ezaudio_tpu_torch.ops.kernels.resunit import residual_unit_g, residual_unit_plain

    x, w7, b7, w1, b1, a1, be1, a2, be2 = args
    C = x.shape[-1]
    got = (fn(*args, dilation) if got is None else got).float()
    want = residual_unit_plain(*args, dilation).float()
    probe = (torch.eye(C, device=x.device) * G_PROBE).to(x.dtype)
    g_got = fn(x, w7, b7, probe, torch.zeros_like(b1), a1, be1, a2, be2,
               dilation).float() / G_PROBE
    g_want = residual_unit_g(x, w7, b7, a1, be1, a2, be2, dilation)
    h_max = snake_beta_vae(x.float(), a1.float(), be1.float()).abs().max().item()
    a2, be2 = a2.float(), be2.float()
    g_slack = (2.0 ** -7 * h_max * w7.float().abs().max().item()
               * (1.0 + (a2 / (be2 + 1e-9)).abs().max().item()))
    g_ok, g_err, g_share = bf16_agreement(g_got, g_want, g_slack)
    dg = (g_got - g_want).abs()
    g_ratio = (dg / (2.0 ** -7 * g_want.abs() + 1e-5 + g_slack)).max().item()
    flips = (dg > 0).sum(-1)
    allowed = 2.0 ** -8 * (got.abs() + want.abs()) + 1e-5 + dg @ w1.float().abs()
    ratio = ((got - want).abs() / allowed).max().item()  # NaN fails below
    stats = dict(max_abs_err=(got - want).abs().max().item(), out_ratio=ratio,
                 g_max_abs_err=g_err, g_slack=g_slack, g_ratio=g_ratio,
                 g_off_ulp_share=g_share,
                 g_diff_share=(flips.sum() / dg.numel()).item(),
                 g_diffs_per_row_max=int(flips.max().item()))
    return bool(g_ok and ratio <= 1.0), stats


def attention_agreement(got, want, v):
    """``(ok, max_abs_err, share of elements beyond one output ulp)`` of
    the kernel's ``got`` against the plain version's ``want``."""
    import torch

    if got.dtype != torch.float32:
        return bf16_agreement(got, want, 2.0 ** -8 * v.float().abs().max())
    diff = (got - want).abs()
    share = (~(diff <= ATTN_F32_ATOL)).float().mean().item()
    return share == 0.0, diff.max().item(), share


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def key_mask(B: int, Lk: int, masked, dev):
    """The (B, Lk) key mask of an ATTN_CASES row, or None."""
    import torch

    if not masked:
        return None
    pos = torch.arange(Lk, device=dev)[None, :]
    if masked == "t5_8":
        return pos < torch.tensor([6 if i < B // 2 else 1 for i in range(B)],
                                  device=dev)[:, None]
    if masked == "concat":
        lead = Lk - 500 - CONCAT_CONTEXT
        valid = torch.tensor([23 if i % 2 == 0 else 1 for i in range(B)], device=dev)
        return (pos < lead) | (pos >= lead + CONCAT_CONTEXT) | (pos < lead + valid[:, None])
    lens = torch.tensor([23 if i % 2 == 0 else Lk for i in range(B)], device=dev)
    return pos < lens[:, None]


def check_attention(dev, gen, cases=ATTN_CASES):
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention

    rows = []
    for (B, H, Lq, Lk, D, masked) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).to(dtype)
                       for L in (Lq, Lk, Lk))
            mask = key_mask(B, Lk, masked, dev)
            got = fused_attention(q, k, v, key_mask=mask)
            want = attention_plain(q, k, v, key_mask=mask)
            sync(dev)
            ok, err, share = attention_agreement(got, want, v)
            sdpa_mask = None if mask is None else mask[:, None, None, :]
            ms = time_ms(lambda: fused_attention(q, k, v, key_mask=mask))
            plain_ms = time_ms(lambda: attention_plain(q, k, v, key_mask=mask))
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask))
            elt = q.element_size()
            nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * elt + (B * Lk if masked else 0)
            bms, by = bound_ms(nbytes, 4.0 * B * H * Lq * Lk * D, dname)
            row = dict(shape=[B, H, Lq, Lk, D], dtype=dname, masked=masked,
                       max_abs_err=err, off_ulp_share=share,
                       ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by)
            log("attention " + json.dumps(row))
            if not ok:
                raise AssertionError(f"attention {row['shape']} {dname}: err {err}, "
                                     f"{share} of the elements beyond one ulp")
            rows.append(row)
    return rows


def resunit_args(dev, gen, B, L, C):
    import torch

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x = rnd(B, L, C)
    w7 = rnd(7, C, C, scale=(7 * C) ** -0.5)
    w1 = rnd(C, C, scale=C ** -0.5)
    b7, b1 = rnd(C, scale=0.1), rnd(C, scale=0.1)
    snk = [rnd(C, scale=0.1).exp() for _ in range(4)]
    return [x, w7, b7, w1, b1, *snk]


def check_resunit(dev, gen, cases=RESUNIT_CASES, dtype="float32"):
    """Kernel 2 against its plain version at ``cases``: f32 within
    RESUNIT_TOL; bf16 (x and weights bf16, snake parameters f32) by
    :func:`resunit_bf16_agreement`."""
    import torch

    from ezaudio_tpu_torch.ops.kernels.resunit import (fused_residual_unit,
                                                       residual_unit_plain)

    rows = []
    for B, L, C, d in cases:
        args = resunit_args(dev, gen, B, L, C)
        args = [a.to(getattr(torch, dtype)) for a in args[:5]] + args[5:]
        got = fused_residual_unit(*args, d)
        if dtype == "float32":
            want = residual_unit_plain(*args, d)
            sync(dev)
            err = (got - want).abs().max().item()
            ok, checked = err <= RESUNIT_TOL, dict(max_abs_err=err, tol=RESUNIT_TOL)
            del want
        else:
            ok, checked = resunit_bf16_agreement(fused_residual_unit, args, d, got)
        del got
        ms = time_ms(lambda: fused_residual_unit(*args, d), reps=3, iters=3)
        plain_ms = time_ms(lambda: residual_unit_plain(*args, d), reps=3, iters=3)
        elt = args[0].element_size()
        nbytes = (2 * B * L * C + 8 * C * C + 2 * C) * elt + 4 * C * 4
        bms, by = bound_ms(nbytes, 2.0 * B * L * C * C * 8, dtype)
        row = dict(shape=[B, L, C], dilation=d, dtype=dtype, **checked,
                   ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bms, bound_by=by)
        log("resunit " + json.dumps(row))
        if not ok:
            raise AssertionError(f"resunit {row['shape']} d={d} {dtype}: {checked}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
def reset_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    for fn in (fused_attention, fused_residual_unit):
        fn.launches = 0
        fn.launches_by_dtype = {}


def read_counters():
    from ezaudio_tpu_torch.ops.kernels.attention import fused_attention
    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit

    return fused_attention.launches, fused_residual_unit.launches


def read_dtype_counters():
    """``{"<kernel>.<dtype>": launches}`` since the last reset."""
    from ezaudio_tpu_torch.api.graphs import kernel_launches_by_dtype

    return kernel_launches_by_dtype()


def want_by_dtype(attn, res, dtype):
    """The launches by dtype of a path whose every launch is in ``dtype``."""
    want = {"attention": attn, "resunit": res}
    return {f"{k}.{dtype}": n for k, n in want.items() if n}


def build_ezaudio(dev="cuda", config=None, model="s3_l", dtype="float32"):
    """``EzAudio(model)`` (or ``config``) on seeded random weights."""
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    t0 = time.perf_counter()
    ez = EzAudio(model, config=config, device=dev, seed=0, dtype=getattr(torch, dtype))
    sync(dev)
    log(f"main: EzAudio({model!r}, {dtype}) built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in ez.dit.parameters()) / 1e9:.3f} B DiT params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return ez


def check_freed(what, before_gib):
    """A deleted model's memory is back (ROADMAP F8): allocated within
    MEM_SLACK_GIB of ``before_gib``, with no garbage collection (cuBLAS's
    cached workspaces released first)."""
    import torch

    # cuBLAS keeps a workspace per stream it ran on (a graph capture's too):
    # the library's cache, not the model's memory
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.backends.cuda.cufft_plan_cache.clear()  # cuFFT's plans (CLAP's STFT), likewise
    now = mem_gib(torch.cuda.memory_allocated)
    log(f"freed {what}: {now:.3f} GiB allocated after del, {before_gib:.3f} before the build")
    if now > before_gib + MEM_SLACK_GIB:
        raise AssertionError(f"{what}: {now:.3f} GiB still allocated after del, "
                             f"{before_gib:.3f} before the build")


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def want_attention(depth: int, steps: int, layer_cache=None, controlnet=False) -> int:
    """Attention launches of one sampler run: each full call runs depth + 1
    blocks (and, with ``controlnet``, the ControlNet's depth // 2), each
    cached call the 2k blocks around the deep cache, and every block
    launches self- and cross-attention once (a CFG pair is one call)."""
    full, cached, k = steps, 0, 0
    if layer_cache is not None:
        k, interval = layer_cache
        cached = (steps // interval) * (interval - 1)
        full = steps - cached
    blocks = depth + 1 + (depth // 2 if controlnet else 0)
    return 2 * (full * blocks + cached * 2 * k)


@contextlib.contextmanager
def resunit_shapes(seen: set, full: bool = False):
    """Add the (L, C) of every ResidualUnit the codec gives the kernel's
    wrapper to ``seen``; with ``full``, its (B, L, C, dilation)."""
    from ezaudio_tpu_torch.codecs import oobleck_fast

    orig = oobleck_fast.fused_residual_unit

    def record(x, *args):
        # (L, C) for f32 inputs, (L, C, "bfloat16") for bf16 ones
        dt = str(x.dtype).rsplit(".", 1)[-1]
        if full:
            seen.add(tuple(x.shape) + (int(args[-1]),))
        else:
            seen.add(tuple(x.shape[1:]) + (() if dt == "float32" else (dt,)))
        return orig(x, *args)

    oobleck_fast.fused_residual_unit = record
    try:
        yield
    finally:
        oobleck_fast.fused_residual_unit = orig


def uncovered_shapes(paths, cases=RESUNIT_CASES, bf16_cases=RESUNIT_BF16_CASES):
    """The ResidualUnit (L, C) of the paths (``(L, C, "bfloat16")`` for a
    bf16 one) that phase 3 does not hold against the plain version."""
    checked = ({(L, C) for _, L, C, _ in cases}
               | {(L, C, "bfloat16") for _, L, C, _ in bf16_cases})
    return sorted({tuple(s) for p in paths for s in p["resunit_shapes"]} - checked)


def check_batch_shapes(row, cases) -> None:
    """Every (B, L, C, dilation) a training path gave the ResidualUnit is
    one of ``cases``, which phase 3 holds against the plain version."""
    missing = sorted(set(row["resunit_batch_shapes"]) - set(cases))
    if missing:
        raise AssertionError(f"ResidualUnit shapes of {row['path']} not in phase 3: {missing}")


def run_path(name, dev, fn, want_attn, want_res, audio_s, want_len, dtype=None):
    """Drive one path with the counters set to 0 just before it and read
    just after; check its launches and output.  ``audio_s`` is the seconds
    of audio the call generates, or a function of the ResidualUnit shapes
    the call gave the kernel (an edit: its window, the longest of them).
    With ``dtype``, every launch must be a launch on ``dtype`` inputs."""
    import numpy as np
    import torch

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    seen = set()
    reset_counters()
    with resunit_shapes(seen):
        t0 = time.perf_counter()
        wav = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    by_dtype = read_dtype_counters()
    if callable(audio_s):
        audio_s = audio_s(seen)
    row = dict(path=name, wav_shape=list(wav.shape), wall_s=wall, audio_s=audio_s,
               audio_s_per_s=audio_s / wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               attention_launches=attn, resunit_launches=res, launches_by_dtype=by_dtype,
               resunit_shapes=sorted(seen, reverse=True),
               wav_abs_max=float(np.abs(wav).max()), wav_std=float(wav.std()))
    log(f"{name} " + json.dumps(row))
    if wav.shape[-1] != want_len or not np.isfinite(wav).all():
        raise AssertionError(f"{name}: output {wav.shape}, finite={np.isfinite(wav).all()}")
    if attn != want_attn or res != want_res:
        raise AssertionError(f"{name}: launch counts {attn}, {res}: want {want_attn}, {want_res}")
    if dtype is not None and by_dtype != want_by_dtype(attn, res, dtype):
        raise AssertionError(f"{name}: launches by dtype {by_dtype}, want all {dtype}")
    row["wav"] = wav  # kept for the comparisons of later phases, not logged
    return row


PROMPTS = ["a dog barking in the rain", "footsteps on gravel",
           "a violin playing a slow melody", "thunder rolling in the distance"]


def main_path(ez, length=10.0):
    """Phase 4: ``generate_audio`` at its defaults for 1 and 4 prompts."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for n in (1, 4):
        row = run_path(f"main[{n}]", ez.device,
                       lambda: ez.generate_audio(PROMPTS[:n], length=length,
                                                 random_seed=1234)[1],
                       2 * (depth + 1) * 100, want_res, n * length, n_samples)
        if row["wav_shape"] != [n, n_samples]:
            raise AssertionError(f"main path output {row['wav_shape']}")
        rows.append(row)
    return rows


def seeded_clip(sr: int, seconds: float):
    """A seeded test clip: two tones and noise."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 1375 * t)
            + 0.05 * noise).astype(np.float32)


def burst_clip(sr: int, seconds: float):
    """``seeded_clip`` in 0.5 s on/off bursts: an energy condition that is
    not flat."""
    import numpy as np

    clip = seeded_clip(sr, seconds)
    on = (np.arange(len(clip)) // int(0.5 * sr)) % 2 == 0
    return (clip * on).astype(np.float32)


def edit_paths(ez, length=10.0, long_steps=100):
    """Phases 6 and 7: ``editing_audio`` at its defaults on a ``length`` s
    clip (mask [0.4, 0.7) of it, boundary 0.2 of it), and
    ``generate_long`` to twice ``length`` in windows of ``length``."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    per_encode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.encoder.modules())
    clip = seeded_clip(ez.sr, length)
    edit = dict(boundary=0.2 * length, mask_start=0.4 * length, mask_length=0.3 * length)
    rows = [run_path("editing", ez.device,
                     lambda: ez.editing_audio("a dog barking", gt_file=clip,
                                              random_seed=7, **edit)[1],
                     2 * (depth + 1) * 100, per_encode + per_decode,
                     lambda seen: max(L for L, _ in seen) / ez.sr, len(clip))]
    log(f"long: {long_steps} steps per call")
    rows.append(run_path(
        "long", ez.device,
        lambda: ez.generate_long("rain on a tin roof", length=2 * length, window=length,
                                 overlap=0.2 * length, ddim_steps=long_steps,
                                 random_seed=11)[1],
        3 * 2 * (depth + 1) * long_steps, per_decode + 2 * (per_encode + per_decode),
        2 * length, int(2 * length * ez.sr)))
    return rows


SAMPLER_RUNS = [
    ("dpm", dict(sampler="dpm", ddim_steps=25)),
    ("dpm_cache_band_refresh", dict(sampler="dpm", ddim_steps=25, layer_cache=(2, 2),
                                    guidance_interval=(300, 800), cfg_refresh=2)),
    ("ddim_cache", dict(ddim_steps=100, layer_cache=(2, 2))),
    ("distilled", dict(sampler="distilled", ddim_steps=8)),
]


def sampler_paths(ez, length=10.0, runs=SAMPLER_RUNS):
    """Phase 8: each fast sampler once, ``length`` s, 1 prompt."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for name, kw in runs:
        want = want_attention(depth, kw["ddim_steps"], kw.get("layer_cache"))
        rows.append(run_path(
            name, ez.device,
            lambda: ez.generate_audio("a dog barking in the rain", length=length,
                                      random_seed=5, **kw)[1],
            want, per_decode, length, n_samples))
    return rows


def last_program(ez):
    """The fused program ``ez`` ran last."""
    return next(reversed(ez._fused.values()))


def mem_gib(fn):
    import torch

    return fn() / 2**30 if torch.cuda.is_available() else None


def fused_run(name, ez, fn, want_attn, want_res, audio_s, replays=2, like=None,
              dtype=None):
    """A fused call's first run (warm-up, capture, instantiation, one
    replay) and ``replays`` more, each checked: equal output across
    replays, the capture's launches equal to a staged call's (with
    ``dtype``, every one on ``dtype`` inputs), the output within FUSED_TOL
    of ``like`` (the staged waveform).  Launches are those of one replay
    times the replays."""
    import numpy as np
    import torch

    cuda = torch.device(ez.device).type == "cuda"
    sync(ez.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem_before = mem_gib(torch.cuda.memory_allocated)
    reset_counters()
    seen = set()
    with resunit_shapes(seen):
        t0 = time.perf_counter()
        wav = fn()
        sync(ez.device)
        first_s = time.perf_counter() - t0
    prog = last_program(ez)
    mem_after = mem_gib(torch.cuda.memory_allocated)
    peak_first = mem_gib(torch.cuda.max_memory_allocated)
    walls = []
    for _ in range(replays):
        t0 = time.perf_counter()
        again = fn()
        sync(ez.device)
        walls.append(time.perf_counter() - t0)
        if not np.array_equal(again, wav):
            raise AssertionError(f"{name}: a replay gave another waveform")
    per = dict(prog.launches) if cuda else None
    per_dtype = dict(prog.launches_by_dtype) if cuda else read_dtype_counters()
    calls = prog.replays if cuda else 1 + replays
    err = None if like is None else float(np.abs(wav - like).max())
    row = dict(path=name, wav_shape=list(wav.shape), first_call_s=first_s,
               **{k: v for k, v in prog.timings.items()}, replay_s=walls,
               audio_s=audio_s, audio_s_per_s=audio_s / statistics.median(walls),
               mem_before_gib=mem_before, mem_after_capture_gib=mem_after,
               peak_first_call_gib=peak_first, launches_per_replay=per,
               launches_by_dtype=per_dtype, replays=calls,
               max_abs_err_vs_staged=err, tol=FUSED_TOL,
               resunit_shapes=sorted(seen, reverse=True))
    log(f"{name} " + json.dumps(row))
    if not np.isfinite(wav).all():
        raise AssertionError(f"{name}: output not finite")
    if err is not None and not err <= FUSED_TOL:
        raise AssertionError(f"{name}: fused and staged differ by {err}")
    if cuda and per != {"attention": want_attn, "resunit": want_res}:
        raise AssertionError(f"{name}: launches per replay {per}: want {want_attn}, {want_res}")
    if not cuda and read_counters() != (want_attn * calls, want_res * calls):
        raise AssertionError(f"{name}: eager launches {read_counters()}")
    if dtype is not None and per_dtype != want_by_dtype(
            *((want_attn, want_res) if cuda else (want_attn * calls, want_res * calls)), dtype):
        raise AssertionError(f"{name}: launches by dtype {per_dtype}, want all {dtype}")
    row.update(attention_launches=want_attn * calls, resunit_launches=want_res * calls,
               wav=wav)
    return row


def fused_paths(ez, staged, length=10.0, replays=2):
    """Phase 10: ``fused=True`` at the main path's recipe for 1 and 4
    prompts; ``staged`` holds phase 4's rows (their waveforms)."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    rows = []
    for n, like in zip((1, 4), staged):
        rows.append(fused_run(
            f"fused[{n}]", ez,
            lambda: ez.generate_audio(PROMPTS[:n], length=length, random_seed=1234,
                                      fused=True)[1],
            2 * (depth + 1) * 100, want_res, n * length, replays, like["wav"]))
    return rows


@contextlib.contextmanager
def int8_shapes(seen: set):
    """Add the (M, K, N) of every int8 product of the DiT to ``seen``."""
    from ezaudio_tpu_torch.ops import quant

    orig = quant.int8_matmul

    def record(a, b):
        seen.add((a.shape[0], a.shape[1], b.shape[0]))
        return orig(a, b)

    quant.int8_matmul = record
    try:
        yield
    finally:
        quant.int8_matmul = orig


def check_int8(dev, gen, shapes):
    """``int8_dot`` on the card against its plain version (the CPU's
    float64 product) on the same inputs, at each (M, K, N): bit-equal.
    Times of what a quantized linear runs per call (``int8_linear`` on the
    cached int8 weight: quantize the rows, ``torch._int_mm``, rescale) and
    of the f32 product it replaces (TF32 off): back to back from the host
    (``*_ms``) and replayed from a CUDA graph (``*_graph_ms``, device
    time alone)."""
    import torch

    from ezaudio_tpu_torch.ops.quant import int8_dot, int8_linear, quantize_symmetric

    rows = []
    for M, K, N in sorted(shapes):
        x = torch.randn(M, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen) * K ** -0.5
        got = int8_dot(x, w)
        want = int8_dot(x.cpu(), w.cpu())
        equal = bool(torch.equal(got.cpu(), want))
        wq, ws = quantize_symmetric(w.t().contiguous(), -1)
        row = dict(shape=[M, K, N], bit_equal=equal,
                   max_abs_err=(got.cpu() - want).abs().max().item(),
                   int8_ms=time_ms(lambda: int8_linear(x, wq, ws)),
                   f32_matmul_ms=time_ms(lambda: x @ w),
                   int8_graph_ms=graph_ms(lambda: int8_linear(x, wq, ws)),
                   f32_matmul_graph_ms=graph_ms(lambda: x @ w))
        log("int8 " + json.dumps(row))
        if not equal:
            raise AssertionError(f"int8_dot {row['shape']}: card and plain differ")
        rows.append(row)
    return rows


def int8_paths(ez, gen, f32_row=None, length=10.0, steps=100):
    """Phase 11: ``quant='int8'`` at the main path's recipe with ``steps``
    DDIM steps, 1 prompt, staged (launches as an f32 call's) and fused
    (equal to staged), and ``int8_dot`` against its plain version at every
    shape of the run; the distance to ``f32_row`` (an f32 call of the same
    recipe) printed when given."""
    import numpy as np

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    shapes = set()

    def call(**kw):
        return ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234,
                                 quant="int8", ddim_steps=steps, **kw)[1]

    with int8_shapes(shapes):
        row = run_path("int8[1]", ez.device, call, want_attention(depth, steps), want_res,
                       length, n_samples)
    row.update(int8_shapes=sorted(shapes))
    if f32_row is not None:
        f32 = f32_row["wav"]
        row.update(vs_f32_max_abs=float(np.abs(row["wav"] - f32).max()),
                   vs_f32_corr=float(np.corrcoef(row["wav"].ravel(), f32.ravel())[0, 1]))
    log("int8[1] shapes " + json.dumps({k: row[k] for k in
                                        ("int8_shapes", "vs_f32_max_abs", "vs_f32_corr")
                                        if k in row}))
    if not any(m <= 16 for m, _, _ in shapes):
        raise AssertionError("int8: no product with 16 rows or fewer (the time MLPs)")
    int8_rows = check_int8(ez.device, gen, shapes)
    fused = fused_run("fused_int8[1]", ez, lambda: call(fused=True),
                      want_attention(depth, steps), want_res, length, 1, row["wav"])
    return [row, fused], int8_rows


def latency_stats(lat):
    import numpy as np

    return dict(p50_s=float(np.percentile(lat, 50)), max_s=float(np.max(lat)))


def served_paths(ez, fused=False, clip_s=10.0, steps=25, lengths=(10.0,) * 4 + (4.0,) * 2,
                 name=None):
    """Phase 12: a GenerationServer (DPM, ``steps`` steps, batches of up to
    4, length buckets 5 s and 10 s) given the ``lengths`` requests and phase
    6's edit at once; every future resolves; fewer generate batches than
    generate requests; returns the row and the results.  With ``fused``,
    a signature met for the first time is warmed up and captured, one met
    before is replayed."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    depth = ez.params_cfg.model.depth
    clip = seeded_clip(ez.sr, clip_s)
    edit = dict(boundary=0.2 * clip_s, mask_start=0.4 * clip_s, mask_length=0.3 * clip_s)
    name = name or ("served_fused" if fused else "served")
    buckets = [0.5 * max(lengths), max(lengths)]
    srv = GenerationServer(ez, max_batch_size=4, max_wait_ms=100, length=max(lengths),
                           length_buckets=buckets, ddim_steps=steps, sampler="dpm",
                           fused=fused)
    seen = set()
    reset_counters()
    replays_before = {k: p.replays for k, p in ez._fused.items()}
    sync(ez.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        futs, submitted = [], []
        for i, length in enumerate(lengths):
            submitted.append(time.perf_counter())
            futs.append(srv.submit(PROMPTS[i % 4], seed=100 + i, length=length))
        submitted.append(time.perf_counter())
        futs.append(srv.submit_edit("a dog barking", gt_file=clip, seed=7, **edit))
        done, outs = [], []
        for f in futs:
            outs.append(f.result(timeout=600))
            done.append(time.perf_counter())
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    gen_batches = stats["batches"] - stats["edit_requests"]
    lat = [d - s for d, s in zip(done, submitted)]
    # every generate batch holds <= 4 clips: one decode call of 12 units;
    # an edit encodes and decodes its window
    per_call, edits = 2 * (depth + 1) * steps, stats["edit_requests"]
    if not fused or ez.device.type != "cuda":  # no graphs: every call runs eagerly
        want = (per_call * stats["batches"], 12 * gen_batches + 24 * edits)
        launches = (attn, res)
    else:
        # the generate batches replay graphs: the counters see the edits
        # and each new program's warm-up and capture, the replays come from
        # the captures' records
        new = [k for k in ez._fused if k not in replays_before]
        ran = {k: p for k, p in ez._fused.items() if p.replays != replays_before.get(k, 0)}
        if any(p.launches != {"attention": per_call, "resunit": 12} for p in ran.values()):
            raise AssertionError(f"{name}: launches per replay "
                                 f"{[p.launches for p in ran.values()]}")
        replayed = sum(p.replays - replays_before.get(k, 0) for k, p in ran.items())
        want = (per_call * (edits + 2 * len(new)), 24 * edits + 24 * len(new))
        launches = (per_call * (edits + replayed), 24 * edits + 12 * replayed)
    row = dict(path=name, requests=len(futs), wall_s=wall, **latency_stats(lat),
               audio_s=float(sum(lengths)) + 0.6 * clip_s, stats=stats,
               attention_launches=launches[0], resunit_launches=launches[1],
               resunit_shapes=sorted(seen, reverse=True),
               wav_shapes=[list(np.shape(w)) for _, w in outs])
    log(f"{name} " + json.dumps(row))
    if (attn, res) != want:
        raise AssertionError(f"{name}: counters {attn}, {res}: want {want}")
    if gen_batches >= len(lengths):
        raise AssertionError(f"{name}: {gen_batches} generate batches for "
                             f"{len(lengths)} requests")
    for (sr, w), length in zip(outs, list(lengths) + [clip_s]):
        if w.shape != (int(length * sr),) or not np.isfinite(w).all():
            raise AssertionError(f"{name}: output {w.shape} for {length} s")
    row["outs"] = [w for _, w in outs]
    row["requests_made"] = dict(lengths=list(lengths), edit=edit, clip=clip, steps=steps)
    return row


def served_checks(ez, staged, *fused):
    """Phase 12's comparisons: two served waveforms (a 10 s and a 4 s
    request) against their solo calls, the served edit against the direct
    call, and each fused server's waveforms against the staged server's."""
    import numpy as np

    req = staged["requests_made"]
    lengths, steps = req["lengths"], req["steps"]
    rows = []
    for i in (0, len(lengths) - 1):
        bucket = max(lengths) if lengths[i] > 0.5 * max(lengths) else 0.5 * max(lengths)
        _, solo = ez.generate_audio(PROMPTS[i % 4], length=bucket, ddim_steps=steps,
                                    sampler="dpm", random_seed=100 + i)
        got = staged["outs"][i]
        rows.append(agreement(f"served_vs_solo[{i}]", got, solo[: got.shape[0]],
                              dict(length=lengths[i], bucket=bucket)))
    _, direct = ez.editing_audio("a dog barking", gt_file=req["clip"], random_seed=7,
                                 ddim_steps=steps, **req["edit"])
    rows.append(agreement("served_edit_vs_direct", staged["outs"][-1], direct, {}))
    for run in fused:
        err = max(float(np.abs(a - b).max()) for a, b in zip(run["outs"], staged["outs"]))
        row = dict(max_abs_err=err, tol=FUSED_TOL)
        log(f"{run['path']}_vs_served " + json.dumps(row))
        if not err <= FUSED_TOL:
            raise AssertionError(f"{run['path']} and served differ by {err}")
    return rows


def card_vs_cpu(gen, dev="cuda", cfg=None):
    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    gpu = EzAudio(config=cfg, device=dev, seed=3)
    cpu = EzAudio(config=cfg, device="cpu", seed=3)
    for a, b in ((gpu.dit, cpu.dit), (gpu.t5, cpu.t5),
                 (gpu.autoencoder.model, cpu.autoencoder.model)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    noise = torch.randn(2, gpu.latent_sr, gpu.latent_dim, generator=gen, device=dev).cpu()
    kw = dict(length=1.0, ddim_steps=3, eta=0.0, random_seed=0, initial_latents=noise)
    prompts = ["a dog barking in the rain", "wind through trees"]
    reset_counters()
    _, wg = gpu.generate_audio(prompts, **kw)
    attn, res = read_counters()
    _, wc = cpu.generate_audio(prompts, **kw)
    # the sampled latents alone, to place any disagreement before or after decode
    lat_args = (prompts, gpu.latent_sr, 5, 0.75, 3, 0.0, 0)
    lg = gpu._generate_latents(*lat_args, initial_latents=noise).cpu().numpy()
    lc = cpu._generate_latents(*lat_args, initial_latents=noise).numpy()
    lat_rel = float(np.abs(lg - lc).max() / np.abs(lc).max())
    err = float(np.abs(wg - wc).max())
    scale = float(np.abs(wc).max())
    corr = float(np.corrcoef(wg.ravel(), wc.ravel())[0, 1])
    row = dict(shape=list(wg.shape), latent_rel_err=lat_rel, max_abs_err=err,
               ref_abs_max=scale, rel_err=err / scale, corr=corr, rel_tol=PIPE_REL_TOL,
               min_corr=PIPE_MIN_CORR, attention_launches=attn, resunit_launches=res)
    log("card_vs_cpu " + json.dumps(row))
    if not (np.isfinite(wg).all() and lat_rel <= PIPE_REL_TOL
            and err <= PIPE_REL_TOL * scale and corr > PIPE_MIN_CORR):
        raise AssertionError("card and CPU disagree")
    if attn == 0 or res == 0:
        raise AssertionError("reduced pipeline did not reach both kernels")
    return row


@contextlib.contextmanager
def same_draws():
    """Every draw of the port (``utils.randn``) from a CPU generator seeded
    by its call index, then moved to the device: card and CPU runs get the
    same initial latents and VAE posterior noise."""
    import torch

    from ezaudio_tpu_torch import utils

    orig, count = utils.randn, [0]

    def randn(shape, generator, device, dtype=torch.float32):
        count[0] += 1
        g = torch.Generator().manual_seed(1000 + count[0])
        return torch.randn(tuple(shape), generator=g, dtype=dtype).to(device)

    utils.randn = randn
    try:
        yield
    finally:
        utils.randn = orig


def agreement(name, got, want, extra):
    """Card (``got``) against CPU (``want``): max error within PIPE_REL_TOL
    of the CPU output's range and correlation above PIPE_MIN_CORR."""
    import numpy as np

    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
    row = dict(extra, shape=list(got.shape), max_abs_err=err, ref_abs_max=scale,
               rel_err=err / scale, corr=corr, rel_tol=PIPE_REL_TOL, min_corr=PIPE_MIN_CORR)
    log(f"{name} " + json.dumps(row))
    if not (np.isfinite(got).all() and err <= PIPE_REL_TOL * scale and corr > PIPE_MIN_CORR):
        raise AssertionError(f"{name}: card and CPU disagree")
    return row


def card_vs_cpu_fast(dev="cuda", cfg=None, length=1.0):
    """Phase 9: card against CPU, s3_l at full width and depth 4, the same
    weights and draws: (a) ``editing_audio`` at eta 0 (hard paste) on a
    clip of 1.5 ``length`` seconds, compared over its edit window; (b) DPM +
    ``layer_cache=(1, 2)`` + ``guidance_interval`` + ``cfg_refresh=2`` for
    ``length`` seconds."""
    import copy

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("s3_l").to_dict())
    cfg["model"]["depth"] = 4
    gpu = EzAudio(config=cfg, device=dev, seed=4)
    cpu = EzAudio(config=cfg, device="cpu", seed=4)
    for a, b in ((gpu.dit, cpu.dit), (gpu.t5, cpu.t5),
                 (gpu.autoencoder.model, cpu.autoencoder.model)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})

    def both(fn):
        """``fn(ez)`` on the card, then on the CPU, with the same draws;
        the outputs and the card run's launches."""
        outs = []
        for ez in (gpu, cpu):
            reset_counters()
            with same_draws():
                outs.append(fn(ez))
            if ez is gpu:
                launches = read_counters()
        return outs, dict(attention_launches=launches[0], resunit_launches=launches[1])

    clip = seeded_clip(gpu.sr, 1.5 * length)
    (wg, wc), launches = both(lambda ez: ez.editing_audio(
        "a dog barking", gt_file=clip, boundary=0.25 * length, mask_start=0.5 * length,
        mask_length=0.5 * length, ddim_steps=3, eta=0.0, random_seed=3)[1])
    lo, hi = round(0.25 * length * gpu.sr), round(1.25 * length * gpu.sr)  # the window
    rows = [agreement("card_vs_cpu_edit", wg[lo:hi], wc[lo:hi], launches)]
    if launches["attention_launches"] == 0 or launches["resunit_launches"] == 0:
        raise AssertionError("card_vs_cpu_edit did not reach both kernels")

    (wg, wc), launches = both(lambda ez: ez.generate_audio(
        ["wind through trees", "a dog barking"], length=length, ddim_steps=6, sampler="dpm",
        layer_cache=(1, 2), guidance_interval=(300, 800), cfg_refresh=2, random_seed=0)[1])
    rows.append(agreement("card_vs_cpu_dpm_cache", wg, wc, launches))
    if (launches["attention_launches"] != want_attention(4, 6, (1, 2))
            or launches["resunit_launches"] == 0):
        raise AssertionError(f"card_vs_cpu_dpm_cache launches {launches}")
    return rows


def build_controlnet(dev="cuda", config=None, seed=0):
    """``EzAudioControlNet("energy")`` (or ``config``) on seeded random
    weights: the base EzAudio, then the ControlNet from ``seed + 1`` with
    the base's embedders and in-blocks copied in."""
    import torch

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet

    t0 = time.perf_counter()
    cn = EzAudioControlNet("energy", config=config, device=dev, seed=seed)
    sync(dev)
    log(f"controlnet: EzAudioControlNet('energy') built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in cn.controlnet.parameters()) / 1e9:.3f} B ControlNet params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return cn


@contextlib.contextmanager
def controlnet_window(seconds: float):
    """``EzAudioControlNet.generate_audio`` pads or crops every clip to
    ``WINDOW_SECONDS`` (10): set it to ``seconds`` inside."""
    from ezaudio_tpu_torch.api import controlnet

    orig = controlnet.WINDOW_SECONDS
    controlnet.WINDOW_SECONDS = seconds
    try:
        yield
    finally:
        controlnet.WINDOW_SECONDS = orig


CONTROLNET_PROMPT = "a dog barking in the rain"
# (name, generate_audio arguments); the first is the call at its defaults:
# DDIM 50 steps, CFG 3.5, rescale 0, eta 1, conditioning scale 1
CONTROLNET_RUNS = [
    ("controlnet", {}),
    ("controlnet_dpm", dict(sampler="dpm", ddim_steps=25)),
    ("controlnet_int8", dict(quant="int8", ddim_steps=CUT_INT8_STEPS)),
    ("controlnet_dpm_scale0", dict(sampler="dpm", ddim_steps=25, conditioning_scale=0.0)),
]


def controlnet_paths(cn, clip_s=10.0, runs=CONTROLNET_RUNS):
    """Phase 13: ``generate_audio`` on a ``clip_s`` s burst clip at its
    defaults, with DPM-Solver++ at 25 steps, with ``quant='int8'``, and
    with DPM at conditioning scale 0; each run's launches, length and
    finiteness checked; scale 1 and scale 0 must differ by more than 100
    times the card-against-CPU limit of the output's range."""
    import numpy as np

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    base = cn.base
    depth = base.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in base.autoencoder.model.decoder.modules())
    clip = burst_clip(base.sr, clip_s)
    rows = []
    for name, kw in runs:
        steps = kw.get("ddim_steps", 50)
        rows.append(run_path(
            name, cn.device,
            lambda: cn.generate_audio(CONTROLNET_PROMPT, clip, random_seed=21, **kw)[1],
            want_attention(depth, steps, controlnet=True), per_decode, clip_s, len(clip)))
    on, off = (next(r["wav"] for r in rows if r["path"] == p)
               for p in ("controlnet_dpm", "controlnet_dpm_scale0"))
    gap = dict(max_abs_diff=float(np.abs(on - off).max()), ref_abs_max=float(np.abs(on).max()),
               min_rel_diff=100 * PIPE_REL_TOL)
    gap["rel_diff"] = gap["max_abs_diff"] / gap["ref_abs_max"]
    log("controlnet_scale1_vs_scale0 " + json.dumps(gap))
    if not gap["rel_diff"] > gap["min_rel_diff"]:
        raise AssertionError(f"conditioning scale 1 and 0 barely differ: {gap}")
    return rows


def controlnet_card_vs_cpu(dev="cuda", cfg=None, clip_s=1.0):
    """Phase 14: the ControlNet path on the card (kernels) against the CPU
    (plain versions), energy config at full width and depth 4, a ``clip_s``
    s burst clip (the window set to it), 3 DDIM steps at eta 0, the same
    weights and draws."""
    import copy

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("energy").to_dict())
    cfg["model"]["depth"] = 4
    gpu = EzAudioControlNet(config=cfg, device=dev, seed=5)
    cpu = EzAudioControlNet(config=cfg, device="cpu", seed=5)
    for a, b in ((gpu.base.dit, cpu.base.dit), (gpu.base.t5, cpu.base.t5),
                 (gpu.base.autoencoder.model, cpu.base.autoencoder.model),
                 (gpu.controlnet, cpu.controlnet)):
        b.load_state_dict({k: v.cpu() for k, v in a.state_dict().items()})
    clip = burst_clip(gpu.base.sr, clip_s)
    outs = []
    with controlnet_window(clip_s):
        for cn in (gpu, cpu):
            reset_counters()
            with same_draws():
                outs.append(cn.generate_audio(CONTROLNET_PROMPT, clip, ddim_steps=3, eta=0.0,
                                              random_seed=3)[1])
            if cn is gpu:
                attn, res = read_counters()
    row = agreement("controlnet_card_vs_cpu", outs[0], outs[1],
                    dict(attention_launches=attn, resunit_launches=res))
    if (attn, res) != (want_attention(4, 3, controlnet=True), 12):
        raise AssertionError(f"controlnet_card_vs_cpu launches {attn}, {res}")
    return row


def controlnet_served(cn, clip_s=10.0, steps=25, lengths=(10.0, 10.0)):
    """Phase 15: a ``GenerationServer(cn.base, controlnet=cn)`` (DPM,
    ``steps`` steps, batches of up to 4) given the ``lengths`` generate
    requests and one ControlNet request at once; launches and lengths
    checked, one ControlNet request counted, and the served ControlNet
    waveform equal to the direct call within FUSED_TOL."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    base = cn.base
    depth = base.params_cfg.model.depth
    clip = burst_clip(base.sr, clip_s)
    srv = GenerationServer(base, controlnet=cn, max_batch_size=4, max_wait_ms=100,
                           length=max(lengths), ddim_steps=steps, sampler="dpm")
    seen = set()
    reset_counters()
    sync(base.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        futs = [srv.submit(PROMPTS[i % 4], seed=200 + i, length=length)
                for i, length in enumerate(lengths)]
        futs.append(srv.submit_controlnet(CONTROLNET_PROMPT, clip, seed=21))
        outs, lat = [], []
        for f in futs:
            outs.append(f.result(timeout=600)[1])
            lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    n_cn = stats["controlnet_requests"]
    gen_batches = stats["batches"] - n_cn
    want = (want_attention(depth, steps) * gen_batches
            + want_attention(depth, steps, controlnet=True) * n_cn,
            12 * (gen_batches + n_cn))
    _, direct = cn.generate_audio(CONTROLNET_PROMPT, clip, sampler="dpm", ddim_steps=steps,
                                  random_seed=21)
    err = float(np.abs(outs[-1] - direct).max())
    row = dict(path="controlnet_served", requests=len(futs), wall_s=wall,
               **latency_stats(lat), audio_s=float(sum(lengths)) + clip_s, stats=stats,
               attention_launches=attn, resunit_launches=res,
               resunit_shapes=sorted(seen, reverse=True),
               wav_shapes=[list(np.shape(w)) for w in outs],
               controlnet_vs_direct_max_abs_err=err, tol=FUSED_TOL)
    log("controlnet_served " + json.dumps(row))
    if n_cn != 1:
        raise AssertionError(f"controlnet_served: {n_cn} ControlNet requests counted")
    if (attn, res) != want:
        raise AssertionError(f"controlnet_served: counters {attn}, {res}: want {want}")
    for w, length in zip(outs, list(lengths) + [clip_s]):
        if w.shape != (int(length * base.sr),) or not np.isfinite(w).all():
            raise AssertionError(f"controlnet_served: output {w.shape} for {length} s")
    if not err <= FUSED_TOL:
        raise AssertionError(f"controlnet_served: served and direct differ by {err}")
    return row


def vs_f32(name, got, f32):
    """Phase 16's printed comparison of a bf16 waveform with the f32 one
    at the same seed (no limit: another precision)."""
    import numpy as np

    row = dict(max_abs_diff=float(np.abs(got - f32).max()),
               ref_abs_max=float(np.abs(f32).max()),
               corr=float(np.corrcoef(got.ravel(), f32.ravel())[0, 1]))
    log(f"{name}_vs_f32 " + json.dumps(row))
    return row


def bf16_paths(ez, f32_rows, length=10.0, replays=2):
    """Phase 16: the bf16 ``ez`` at the main path's recipe, 1 and 4 prompts
    staged and 1 prompt fused (equal to staged); ``f32_rows`` are phase 4's
    rows, whose waveforms the bf16 ones are printed against."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    rows = []
    for n, f32 in zip((1, 4), f32_rows):
        row = run_path(f"bf16_main[{n}]", ez.device,
                       lambda: ez.generate_audio(PROMPTS[:n], length=length,
                                                 random_seed=1234)[1],
                       want_attention(depth, 100), want_res, n * length, n_samples,
                       dtype="bfloat16")
        row["vs_f32"] = vs_f32(row["path"], row["wav"], f32["wav"])
        rows.append(row)
    rows.append(fused_run(
        "bf16_fused[1]", ez,
        lambda: ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234,
                                  fused=True)[1],
        want_attention(depth, 100), want_res, length, replays, rows[0]["wav"], "bfloat16"))
    return rows


def bf16_card_vs_cpu(gen, dev="cuda", cfg=None, length=1.0):
    """Phase 17: bf16 on the card (kernels) against bf16 on the CPU (plain
    versions), s3_l at full width and depth 4, the same weights and initial
    latents, ``length`` s, 3 DDIM steps, eta 0; the CPU's f32 output on the
    f32 weights the bf16 ones were cast from is the yardstick.  Every card
    launch bf16."""
    import copy

    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import EzAudio
    from ezaudio_tpu_torch.config import get_model_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("s3_l").to_dict())
    cfg["model"]["depth"] = 4
    cpu32 = EzAudio(config=cfg, device="cpu", seed=6)
    cpu = EzAudio(config=cfg, device="cpu", seed=6, dtype=torch.bfloat16)
    gpu = EzAudio(config=cfg, device=dev, seed=6, dtype=torch.bfloat16)
    for a, b in ((cpu.dit, gpu.dit), (cpu.t5, gpu.t5),
                 (cpu.autoencoder.model, gpu.autoencoder.model)):
        b.load_state_dict(a.state_dict())
    frames = int(length * gpu.latent_sr)
    noise = torch.randn(2, frames, gpu.latent_dim, generator=gen, device=dev).cpu()
    kw = dict(length=length, ddim_steps=3, eta=0.0, random_seed=0, initial_latents=noise)
    prompts = ["a dog barking in the rain", "wind through trees"]
    reset_counters()
    _, wg = gpu.generate_audio(prompts, **kw)
    attn, res = read_counters()
    by_dtype = read_dtype_counters()
    _, wc = cpu.generate_audio(prompts, **kw)
    _, w32 = cpu32.generate_audio(prompts, **kw)
    err, ref = float(np.abs(wg - wc).max()), float(np.abs(wc - w32).max())
    scale = float(np.abs(wc).max())
    corr = float(np.corrcoef(wg.ravel(), wc.ravel())[0, 1])
    row = dict(shape=list(wg.shape), max_abs_err=err, bf16_vs_f32_max_abs=ref,
               ref_abs_max=scale, rel_err=err / scale, bf16_vs_f32_rel=ref / scale, corr=corr,
               bf16_vs_f32_corr=float(np.corrcoef(wc.ravel(), w32.ravel())[0, 1]),
               ref_factor=BF16_REF_FACTOR, min_corr=BF16_PIPE_MIN_CORR,
               attention_launches=attn, resunit_launches=res, launches_by_dtype=by_dtype)
    log("bf16_card_vs_cpu " + json.dumps(row))
    if not (np.isfinite(wg).all() and 0 < ref and err <= BF16_REF_FACTOR * ref
            and corr > BF16_PIPE_MIN_CORR):
        raise AssertionError("bf16: card and CPU disagree")
    if (attn, res) != (want_attention(4, 3), 12) or by_dtype != want_by_dtype(attn, res,
                                                                             "bfloat16"):
        raise AssertionError(f"bf16_card_vs_cpu launches {by_dtype}")
    return row


def unfold_weight_norm(sd):
    """A folded VAE state dict in the reference's weight-norm form: each
    conv weight W as ``weight_v`` = W times a fixed positive scale per
    first-axis channel and ``weight_g`` = ||W|| over the other axes."""
    import torch

    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            c = 1.0 + 0.5 * torch.sin(torch.arange(v.shape[0], dtype=v.dtype,
                                                   device=v.device))[:, None, None]
            out[k + "_v"] = v * c
            out[k + "_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        else:
            out[k] = v
    return out


def write_checkpoints(cn, d):
    """``cn``'s base and ControlNet in the reference formats under ``d``."""
    import torch

    base = cn.base
    host = {k: v.cpu() for k, v in base.t5.state_dict().items()}
    t5 = {"shared.weight": host.pop("embed_tokens.weight")}
    t5.update({"encoder." + k: v for k, v in host.items()})
    vae = unfold_weight_norm(base.autoencoder.model.state_dict())
    files = dict(
        ckpt_path=("dit.pt", {"model": base.dit.state_dict()}),
        vae_path=("vae.pt", {"state_dict": {"autoencoder." + k: v.cpu()
                                            for k, v in vae.items()}}),
        t5_path=("t5.pt", t5),
        controlnet_path=("controlnet.pt", {"model": cn.controlnet.state_dict()}))
    paths = {}
    for key, (name, obj) in files.items():
        paths[key] = os.path.join(d, name)
        torch.save(obj, paths[key])
    return paths


def checkpoint_round_trip(cn, length=2.0, steps=5):
    """Phase 18: ``cn`` (f32, seeded) written in the reference formats to a
    temporary directory, loaded back through ``EzAudio(ckpt_path=,
    vae_path=, t5_path=)`` and ``EzAudioControlNet(controlnet_path=)`` onto
    the same device; a ``length`` s DDIM call (eta 0, given initial
    latents) and a ControlNet DPM call (the window set to ``length``) equal
    the writer's within CKPT_REL_TOL of the range."""
    import tempfile

    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    base = cn.base
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_checkpoints(cn, d)
        write_s = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths.values()) / 2**30
        t0 = time.perf_counter()
        ez = EzAudio(config=base.params_cfg.to_dict(), device=base.device,
                     **{k: paths[k] for k in ("ckpt_path", "vae_path", "t5_path")})
        cn2 = EzAudioControlNet(base=ez, controlnet_path=paths["controlnet_path"])
        sync(base.device)
        load_s = time.perf_counter() - t0
    on_device = all(t.device.type == base.device.type
                    for m in (ez.dit, ez.t5, ez.autoencoder.model, cn2.controlnet)
                    for t in m.state_dict().values())
    frames = int(length * base.latent_sr)
    noise = torch.randn(1, frames, base.latent_dim, generator=torch.Generator().manual_seed(8))
    kw = dict(length=length, ddim_steps=steps, eta=0.0, random_seed=0, initial_latents=noise)
    want = base.generate_audio(PROMPTS[0], **kw)[1]
    got = ez.generate_audio(PROMPTS[0], **kw)[1]
    clip = burst_clip(base.sr, length)
    with controlnet_window(length):
        ckw = dict(sampler="dpm", ddim_steps=steps, random_seed=21)
        cwant = cn.generate_audio(CONTROLNET_PROMPT, clip, **ckw)[1]
        cgot = cn2.generate_audio(CONTROLNET_PROMPT, clip, **ckw)[1]
    errs = [float(np.abs(a - b).max()) / float(np.abs(b).max())
            for a, b in ((got, want), (cgot, cwant))]
    row = dict(files_gib=size, write_s=write_s, load_s=load_s, weights_on_device=on_device,
               generate_rel_err=errs[0], controlnet_rel_err=errs[1], rel_tol=CKPT_REL_TOL)
    log("checkpoint_round_trip " + json.dumps(row))
    if not (on_device and all(e <= CKPT_REL_TOL for e in errs)
            and np.isfinite(got).all() and np.isfinite(cgot).all()):
        raise AssertionError(f"checkpoint round trip: {row}")
    return row


def s3_xl_path(dev="cuda", config=None, length=10.0):
    """Phase 19: s3_xl in bf16 at full width and depth, ``generate_audio``
    at its defaults for 1 prompt; every launch bf16."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    ez = build_ezaudio(dev, config=config, model="s3_xl", dtype="bfloat16")
    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    return run_path("s3_xl_bf16[1]", ez.device,
                    lambda: ez.generate_audio(PROMPTS[:1], length=length, random_seed=1234)[1],
                    want_attention(depth, 100), want_res, length, n_samples, dtype="bfloat16")


# ---------------------------------------------------------------------------
# Phases 20-22: CLAP reranking and the HuBERT (ContentVec) conditioner
CLAP_IDS_LENGTHS = (32, 20, 11, 7)


def clap_ids(vocab: int = 50265, pad: int = 1, lengths=CLAP_IDS_LENGTHS, seed: int = 0):
    """Seeded RoBERTa ids (len(lengths), max(lengths)): BOS 0, random
    tokens, and each row shorter than the longest padded with the pad id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.full((len(lengths), max(lengths)), pad, np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(3, vocab, n)
        ids[b, 0] = 0
    return ids


def build_scorer(dev="cuda", cfg=None):
    """``CLAPScorer(cfg)`` (``laion/clap-htsat-unfused`` widths by default)
    on seeded random weights."""
    import torch

    from ezaudio_tpu_torch.audio.clap import CLAPScorer

    t0 = time.perf_counter()
    scorer = CLAPScorer(cfg, device=dev)
    sync(dev)
    log(f"rerank: CLAPScorer built in {time.perf_counter() - t0:.2f} s, "
        f"{sum(p.numel() for p in scorer.model.parameters()) / 1e6:.1f} M params, "
        f"{mem_gib(torch.cuda.memory_allocated)} GiB allocated")
    return scorer


def rerank_path(ez, scorer, ids, row=2, n_candidates=4, length=10.0, steps=100):
    """Phase 20: ``generate_audio_reranked`` on 1 prompt at the reference
    recipe (``steps`` DDIM steps), ``n_candidates`` candidates in one batched
    call, scored against CLAP ids row ``row``; then the scoring alone, timed."""
    import numpy as np

    from ezaudio_tpu_torch.audio.clap import prepare_clap_audio
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    per_decode = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    out = {}

    def call():
        sr, best, allw, scores = ez.generate_audio_reranked(
            PROMPTS[:1], scorer, n_candidates=n_candidates, text_ids=ids[row:row + 1],
            return_all=True, length=length, random_seed=1234, ddim_steps=steps)
        out.update(sr=sr, all=allw[0], scores=scores[0])
        return best[0]

    res = run_path(f"rerank[1x{n_candidates}]", ez.device, call, want_attention(depth, steps),
                   per_decode * -(-n_candidates // 4), length, n_samples)
    if out["all"].shape != (n_candidates, n_samples) or not np.isfinite(out["scores"]).all():
        raise AssertionError(f"rerank: candidates {out['all'].shape}, scores {out['scores']}")
    sr, wavs, dev = out["sr"], out["all"], ez.device

    def wall_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            fn()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    feats = prepare_clap_audio(wavs, sr, device=scorer.device)
    res.update(out, row=row, score_ms=dict(
        embed_audio=wall_ms(lambda: scorer.embed_audio(wavs, sr)),
        prepare_audio=wall_ms(lambda: prepare_clap_audio(wavs, sr, device=scorer.device)),
        audio_tower=wall_ms(lambda: scorer.model(input_features=feats)),
        embed_text=wall_ms(lambda: scorer.embed_text(ids[row:row + 1]))))
    log("rerank_scores " + json.dumps(dict(scores=out["scores"].tolist(),
                                           score_ms=res["score_ms"])))
    return res


CLAP_EMBED_ATOL = 1e-4  # card against CPU, unit embeddings
CLAP_TIE = 2e-4         # the choice may differ where the CPU's top two are this close
CLAP_SCORE_ATOL = 2e-4  # card against CPU, the candidates' scores


def clap_agreement(name, got_audio, want_audio, got_text, want_text, got_scores, want_scores):
    """Card (``got_*``) against CPU (``want_*``): both embeddings within
    CLAP_EMBED_ATOL; the same best candidate per prompt unless the CPU's
    top two scores are within CLAP_TIE (a tie the card may break the other
    way); the scores within CLAP_SCORE_ATOL."""
    import numpy as np

    got_audio, want_audio, got_text, want_text, got_scores, want_scores = (
        np.asarray(x, np.float64) for x in (got_audio, want_audio, got_text, want_text,
                                           got_scores, want_scores))
    err_a = float(np.abs(got_audio - want_audio).max())
    err_t = float(np.abs(got_text - want_text).max())
    top2 = np.sort(want_scores, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > CLAP_TIE
    same = got_scores.argmax(-1) == want_scores.argmax(-1)
    err_s = float(np.abs(got_scores - want_scores).max())
    row = dict(audio_max_abs_err=err_a, text_max_abs_err=err_t, atol=CLAP_EMBED_ATOL,
               scores_max_abs_err=err_s, scores_atol=CLAP_SCORE_ATOL,
               top_two_gap=(top2[..., 1] - top2[..., 0]).tolist(),
               card_choice=got_scores.argmax(-1).tolist(),
               cpu_choice=want_scores.argmax(-1).tolist(), decided=decided.tolist(),
               tie=CLAP_TIE)
    log(f"{name} " + json.dumps(row))
    if not (np.isfinite(got_audio).all() and np.isfinite(got_text).all()
            and err_a <= CLAP_EMBED_ATOL and err_t <= CLAP_EMBED_ATOL):
        raise AssertionError(f"{name}: card and CPU embeddings disagree")
    if not np.all(same | ~decided):
        raise AssertionError(f"{name}: card and CPU choose different candidates")
    if not err_s <= CLAP_SCORE_ATOL:
        raise AssertionError(f"{name}: card and CPU scores disagree")
    return row


def clap_card_vs_cpu(scorer, res, ids):
    """Phase 20's check: the card's candidates scored again by the port's
    CPU ``CLAPScorer`` on the same weights."""
    import torch

    from ezaudio_tpu_torch.audio.clap import CLAPScorer

    cpu = CLAPScorer(scorer.cfg, device="cpu",
                     weights={k: v.cpu() for k, v in scorer.model.state_dict().items()})
    got_a = scorer.embed_audio(res["all"], res["sr"]).cpu()
    want_a = cpu.embed_audio(res["all"], res["sr"])
    got_t, want_t = scorer.embed_text(ids).cpu(), cpu.embed_text(ids)
    row = res["row"]
    want_scores = torch.einsum("kd,d->k", want_a, want_t[row])
    return clap_agreement("rerank_card_vs_cpu", got_a, want_a, got_t, want_t, res["scores"],
                          want_scores)


def served_rerank(ez, scorer, ids, row=2, steps=25, length=10.0):
    """Phase 21: a ``GenerationServer(ez, clap_scorer=scorer)`` whose recipe
    (DPM, ``steps`` steps) has ``fused=True`` given one ``submit_reranked``
    (4 candidates) and one plain request: the rerank runs staged and equals
    the direct call (phase 12's rule), one rerank request is counted, and
    the counters show the staged rerank plus the plain request's program."""
    import numpy as np

    from ezaudio_tpu_torch.serving import GenerationServer

    depth = ez.params_cfg.model.depth
    text_ids = ids[row:row + 1]
    srv = GenerationServer(ez, clap_scorer=scorer, max_batch_size=4, max_wait_ms=100,
                           length=length, ddim_steps=steps, sampler="dpm", fused=True)
    seen = set()
    replays_before = {k: p.replays for k, p in ez._fused.items()}
    reset_counters()
    sync(ez.device)
    with resunit_shapes(seen), srv:
        t0 = time.perf_counter()
        fut_r = srv.submit_reranked(PROMPTS[0], n_candidates=4, seed=31, text_ids=text_ids)
        fut_g = srv.submit(PROMPTS[1], seed=32)
        (sr, wav), lat = fut_r.result(timeout=600), [time.perf_counter() - t0]
        plain = fut_g.result(timeout=600)[1]
        lat.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    stats = dict(srv.stats)
    per_call = want_attention(depth, steps)
    new = [k for k in ez._fused if k not in replays_before]
    replayed = sum(p.replays - replays_before.get(k, 0) for k, p in ez._fused.items())
    if ez.device.type != "cuda":  # no graphs: the plain request runs eagerly
        want, launches = (2 * per_call, 24), (attn, res)
    else:  # its program's warm-up and capture pass the counters, replays do not
        want = (per_call * (1 + 2 * len(new)), 12 * (1 + 2 * len(new)))
        launches = (per_call * (1 + replayed), 12 * (1 + replayed))
    row_ = dict(path="served_rerank", requests=2, wall_s=wall, **latency_stats(lat),
                audio_s=2 * length, stats=stats, attention_launches=launches[0],
                resunit_launches=launches[1], resunit_shapes=sorted(seen, reverse=True),
                new_programs=len(new), replays=replayed)
    log("served_rerank " + json.dumps(row_))
    if stats["rerank_requests"] != 1:
        raise AssertionError(f"served_rerank: {stats['rerank_requests']} rerank requests")
    if (attn, res) != want:
        raise AssertionError(f"served_rerank: counters {attn}, {res}: want {want}")
    n = int(length * sr)
    for w in (wav, plain):
        if w.shape != (n,) or not np.isfinite(w).all():
            raise AssertionError(f"served_rerank: output {w.shape} for {length} s")
    _, direct = ez.generate_audio_reranked(PROMPTS[0], scorer, n_candidates=4,
                                           text_ids=text_ids, random_seed=31, length=length,
                                           ddim_steps=steps, sampler="dpm")
    row_["vs_direct"] = agreement("served_rerank_vs_direct", wav, direct, {})
    return row_


def vc_frames(cfg, sr: int, seconds: float) -> int:
    """ContentVec frames of ``seconds`` at ``sr``: resampled to 16 kHz,
    padded by 40 samples on each side, through the conv stack."""
    n = -(-int(seconds * sr) * 16000 // sr) + 80
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


def check_vc_shape(feats, cfg, sr: int, seconds: float, latent_sr: int = 50):
    """One ContentVec frame per latent frame: (1, seconds * latent_sr,
    hidden_size)."""
    want = (1, vc_frames(cfg, sr, seconds), cfg.hidden_size)
    if tuple(feats.shape) != want or want[1] != round(seconds * latent_sr):
        raise AssertionError(f"vc: features {tuple(feats.shape)}, want {want} "
                             f"({seconds * latent_sr:g} latent frames)")


def vc_path(dev="cuda", cfg=None, sr=24000, seconds=10.0, reps=5, latent_sr=50):
    """Phase 22: ``Conditioner('vc', sr=sr)`` (ContentVec-base widths by
    default) on a seeded clip: shape, wall (median of ``reps``), peak; then
    the port's CPU extractor on the same weights, within VC_REL_TOL of the
    CPU output's range."""
    import warnings

    import numpy as np
    import torch

    from ezaudio_tpu_torch.models.conditioners import Conditioner
    from ezaudio_tpu_torch.models.hubert import VoiceConversionExtractor

    with warnings.catch_warnings(record=True) as caught:  # random weights: it warns
        warnings.simplefilter("always")
        cond = Conditioner("vc", sr=sr, hubert_config=cfg, device=dev)
    log(f"vc: {sum(p.numel() for p in cond.fn.model.parameters()) / 1e6:.1f} M params; "
        f"warned: {[str(w.message)[:40] for w in caught]}")
    clip = seeded_clip(sr, seconds)[None]
    cuda = torch.device(dev).type == "cuda"
    feats = cond(clip)  # warm-up
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        feats = cond(clip)
        sync(dev)
        times.append(time.perf_counter() - t0)
    check_vc_shape(feats, cond.fn.cfg, sr, seconds, latent_sr)
    cpu = VoiceConversionExtractor(sr, cond.fn.cfg, device="cpu", weights={
        k: v.cpu() for k, v in cond.fn.model.state_dict().items()})
    got, want = feats.float().cpu().numpy(), cpu(clip).numpy()
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    row = dict(path="vc", shape=list(got.shape), wall_s=statistics.median(times),
               wall_s_all=times, peak_mem_gib=mem_gib(torch.cuda.max_memory_allocated)
               if cuda else None, max_abs_err=err, ref_abs_max=scale, rel_err=err / scale,
               rel_tol=VC_REL_TOL)
    log("vc " + json.dumps(row))
    if not (np.isfinite(got).all() and err <= VC_REL_TOL * scale):
        raise AssertionError("vc: card and CPU features disagree")
    return row


# ---------------------------------------------------------------------------
# Training (phases 23-25).  (B, H, Lq, Lk, head_dim, key mask) of the train
# step at batch 8: s3_l self-attention and T5-masked cross-attention.
TRAIN_BATCH = 8
ATTN_GRAD_CASES = [(TRAIN_BATCH, 16, 500, 500, 64, False),
                   (TRAIN_BATCH, 16, 500, 100, 64, True),
                   (TRAIN_BATCH, 16, 600, 600, 64, "concat")]   # concat context (phase 31)
# the DiT train step's encoder third block, and the VAE codec step's first
# (its largest: batch 8 of 12 000 samples at C = 128)
RESUNIT_GRAD_CASES = [(TRAIN_BATCH, 30000, 256, 3), (CODEC_BATCH, 12000, 128, 9)]
# A kernel wrapper's gradients against the plain twin's on the same inputs:
# the backward is the plain twin's vjp in both, so they agree to rounding.
# Each gradient within KERNEL_GRAD_TOL of its largest entry, and none zero
# where the plain twin's is not (a detached output).
KERNEL_GRAD_TOL = 1e-6
# Since that backward is the plain twin's vjp at the saved inputs, the
# comparison above checks only which inputs were saved.  SDPA's gradients
# on the same q, k, v and output gradient are an independent witness: f32
# products summed in another order (TF32 off), each gradient within
# SDPA_GRAD_TOL of its largest entry.
SDPA_GRAD_TOL = 1e-4
# The train step, card against CPU (s3_l widths, depth 2): the loss and the
# grad norm within TRAIN_REL_TOL; each gradient within TRAIN_GRAD_TOL of its
# largest entry (f32 sums in another order over batch, tokens and heads),
# or of GRAD_FLOOR times the largest entry of all gradients where a
# tensor's own gradient is rounding noise around an exact 0 (the bias of
# the cross-attention's key norm shifts every score of a row alike, which
# the softmax ignores: its gradient reads ~3e-11 against a largest entry of
# all gradients of ~0.05, and differs by as much); the updated parameters
# within 2 lr everywhere (Adam's first step moves a parameter by
# lr g / (|g| + eps): a gradient near 0 may take either sign) and, where
# |g| > ADAM_STABLE_GRAD, within 1e-3 lr (the ratio moves by eps dg / g^2
# < 1e-3 for dg < 1e-5) plus two f32 ulps of the parameter (its rounding).
TRAIN_REL_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
# A gradient that is 0 in exact arithmetic (the cross-attention key norm's
# bias: it shifts every score of a row alike, which the softmax ignores;
# in self-attention RoPE rotates it per key, so there it is no zero) is
# rounding noise of the terms that cancel in it.  In phases 26 and 27 that
# noise reads 2.4e-8 of the step's largest gradient (the ControlNet's
# gradients reach it through the frozen backbone; the distillation loss
# regresses v*), more than GRAD_FLOOR * TRAIN_GRAD_TOL (1e-8) allows; phase
# 25 reads ~6e-10.  Such a tensor, named by the caller, is held to be noise
# on both sides: within ZERO_GRAD_TOL of the largest entry of all gradients.
ZERO_GRAD_TOL = 1e-6
ADAM_STABLE_GRAD = 1e-4
# a resumed run's losses against the uninterrupted run's, relative
RESUME_REL_TOL = 1e-5


def grad_agreement(got: dict, want: dict, tol: float, floor: float = 0.0):
    """``(ok, rows)``: each gradient of ``got`` within ``tol`` of the
    largest entry of ``want``'s (or of ``floor`` times the largest entry of
    all of them, where that is more), and none all zero where ``want``'s
    is above that floor."""
    scales = {n: w.float().abs().max().item() for n, w in want.items()}
    least = floor * max(scales.values(), default=0.0)
    rows = {}
    for name, w in want.items():
        g = got[name].float().cpu()
        w = w.float().cpu()
        scale = scales[name]
        err = (g - w).abs().max().item() if g.shape == w.shape else float("inf")
        zero = g.abs().max().item() == 0.0 and scale > least
        rows[name] = dict(max_abs_err=err, scale=scale,
                          rel_err=err / max(scale, least, 1e-30), zero=zero)
    ok = all(r["rel_err"] <= tol and not r["zero"] for r in rows.values())
    return ok, rows


def qkv_grads_nonzero(grads: dict):
    """The q, k and v projection weights of every attention with their
    gradient's largest entry: a detached attention output leaves exactly
    these at 0 (ROADMAP F11)."""
    names = [n for n in grads if any(f"attn.to_{x}.weight" in n for x in "qkv")]
    return {n: grads[n].abs().max().item() for n in names}


def _grad_failures(rows, tol=KERNEL_GRAD_TOL):
    return {n: r for n, r in rows.items() if r["zero"] or not r["rel_err"] <= tol}


def check_attention_grad(dev, gen, cases=ATTN_GRAD_CASES):
    """Phase 23, kernel 1: the autograd gradients through the kernel's
    wrapper against those through the plain twin and SDPA's, the output's
    ``grad_fn``; the backward's time (the plain recompute and its vjp), its
    bound and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention

    rows = []
    for (B, H, Lq, Lk, D, masked) in cases:
        q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).requires_grad_()
                   for L in (Lq, Lk, Lk))
        g = torch.randn(B, H, Lq, D, device=dev, generator=gen)
        mask = key_mask(B, Lk, masked, dev)
        o = fused_attention(q, k, v, key_mask=mask)
        if o.grad_fn is None or type(o.grad_fn).__name__ != "FusedAttentionBackward":
            raise AssertionError(f"attention {B, H, Lq, Lk, D}: output has no kernel grad_fn")
        got = dict(zip("qkv", torch.autograd.grad(o, (q, k, v), g, retain_graph=True)))
        want = dict(zip("qkv", torch.autograd.grad(attention_plain(q, k, v, mask), (q, k, v), g)))
        sync(dev)
        ok, grads = grad_agreement(got, want, KERNEL_GRAD_TOL)
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
            return torch.autograd.grad(out, (q, k, v), g)

        ok_sdpa, by_sdpa = grad_agreement(got, dict(zip("qkv", sdpa_fwd_bwd())), SDPA_GRAD_TOL)

        bwd_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True),
                         reps=3, iters=3)
        lib_ms = time_ms(sdpa_fwd_bwd, reps=3, iters=3)
        # the backward reads q, k, v and the output's gradient once and
        # writes the three gradients; its products: the scores again, dV,
        # dP, dQ and dK
        nbytes = 2 * (2 * Lq + 2 * Lk) * B * H * D * 4 + (B * Lk if masked else 0)
        bms, by = bound_ms(nbytes, 10.0 * B * H * Lq * Lk * D, "float32")
        row = dict(kind="attention_backward", shape=[B, H, Lq, Lk, D], masked=masked,
                   grads={n: {k2: r[k2] for k2 in ("rel_err", "scale")} for n, r in grads.items()},
                   sdpa_rel_err={n: r["rel_err"] for n, r in by_sdpa.items()},
                   backward_ms=bwd_ms, bound_ms=bms, bound_by=by,
                   library_fwd_bwd_ms=lib_ms, grad_fn=type(o.grad_fn).__name__)
        log("attention_grad " + json.dumps(row))
        if not ok:
            raise AssertionError(f"attention gradients {row['shape']}: {_grad_failures(grads)}")
        if not ok_sdpa:
            raise AssertionError(f"attention gradients {row['shape']} against SDPA's: "
                                 f"{_grad_failures(by_sdpa, SDPA_GRAD_TOL)}")
        rows.append(row)
    return rows


def check_resunit_grad(dev, gen, case=RESUNIT_GRAD_CASES[0]):
    """Phase 23, kernel 2: the nine autograd gradients through the kernel's
    wrapper against those through the plain twin at ``case``, and the
    backward's time (``FusedResidualUnit.backward``: the plain twin's
    recompute and vjp, 24 a VAE codec step, one per forward launch of phase
    30's step) beside its bound: the bytes of x, dy, dx and the weights and
    their gradients, and 48 B L C^2 flops (the recompute's conv7 and 1x1,
    16; their weight and input gradients, 32).  No library call computes it."""
    import torch

    from ezaudio_tpu_torch.ops.kernels.resunit import fused_residual_unit, residual_unit_plain

    B, L, C, d = case
    names = ["x", "w7", "b7", "w1", "b1", "a1", "be1", "a2", "be2"]
    args = [a.requires_grad_() for a in resunit_args(dev, gen, B, L, C)]
    g = torch.randn(B, L, C, device=dev, generator=gen)
    y = fused_residual_unit(*args, d)
    if y.grad_fn is None or type(y.grad_fn).__name__ != "FusedResidualUnitBackward":
        raise AssertionError("resunit: output has no kernel grad_fn")
    got = dict(zip(names, torch.autograd.grad(y, args, g, retain_graph=True)))
    want = dict(zip(names, torch.autograd.grad(residual_unit_plain(*args, d), args, g)))
    sync(dev)
    ok, grads = grad_agreement(got, want, KERNEL_GRAD_TOL)
    del got, want
    bwd_ms = time_ms(lambda: torch.autograd.grad(y, args, g, retain_graph=True), reps=3, iters=3)
    nbytes = (3 * B * L * C + 2 * (8 * C * C + 2 * C) + 2 * 4 * C) * 4
    bms, by = bound_ms(nbytes, 48.0 * B * L * C * C, "float32")
    row = dict(kind="resunit_backward", shape=[B, L, C], dilation=d,
               grads={n: r["rel_err"] for n, r in grads.items()},
               backward_ms=bwd_ms, bound_ms=bms, bound_by=by, library_ms=None,
               per_codec_step=24, grad_fn=type(y.grad_fn).__name__)
    log("resunit_grad " + json.dumps(row))
    if not ok:
        raise AssertionError(f"resunit gradients {row['shape']}: {_grad_failures(grads)}")
    return row


def write_training_set(root, clips=16, seconds=10.0, sr=24000, seed=0):
    """``clips`` seeded clips (a tone in bursts over noise, each its own
    pitch) as f32 wav files and a manifest; returns the manifest's path."""
    import csv

    import numpy as np

    from ezaudio_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    rows = []
    for i in range(clips):
        wav = (0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t) * (np.floor(t * (2 + i % 3)) % 2)
               + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        save_wav(os.path.join(root, "audio", f"{i}.wav"), wav, sr)
        rows.append(dict(audio_path=f"{i}.wav", caption=PROMPTS[i % len(PROMPTS)], split="train",
                         audio_length=seconds, absolute_index=i, fine_tune_data=True))
    meta = os.path.join(root, "meta.csv")
    with open(meta, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return meta


def training_config(root, cfg, meta, batch, seconds, sr, warmup=2):
    """``cfg`` (s3_l's) with ``opt:`` and ``data:`` blocks; returns its path."""
    cfg = dict(cfg, opt=dict(learning_rate=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
                             adam_epsilon=1e-8, warmup=warmup, grad_clip=1.0, snr_gamma=None,
                             batch_size=batch, accumulation_steps=1),
               data=dict(train=dict(data_dir=os.path.join(root, "audio"), meta_dir=meta,
                                    subset="train", seg_length=seconds, sr=sr, mono=True)))
    cfg["text_encoder"] = dict(cfg["text_encoder"], cfg=0.1)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def attention_modules(model_cfg: dict) -> int:
    """The attentions of a MaskDiT: self-attention in each of the depth + 1
    blocks, and cross-attention unless the context is concatenated (or
    there is none)."""
    cross = (model_cfg.get("context_dim") is not None
             and model_cfg.get("context_fusion", "cross") == "cross")
    return (model_cfg["depth"] + 1) * (2 if cross else 1)


def train_attention_launches(model_cfg: dict) -> int:
    """Attention launches of one train step: each attention once, twice
    with remat (forward and the backward's recompute); the backward itself
    launches none."""
    return attention_modules(model_cfg) * (2 if model_cfg.get("use_checkpoint") else 1)


# The linears that see the text tokens, and those that see one token per
# sample; every other linear or conv of the DiT sees the latent frames.
TEXT_LINEARS = ("context_embed.", "cross_attn.to_k", "cross_attn.to_v")
SAMPLE_LINEARS = ("time_embed.", "time_ada", "adaln.lora_")


def train_flops(model, batch: int, frames: int, text_len: int, remat: bool = True) -> float:
    """The model FLOPs of one train step of the MaskDiT ``model``: 2 per
    weight of a linear or conv and per token it sees (the frames; the text
    tokens for ``TEXT_LINEARS``; one per sample for ``SAMPLE_LINEARS``),
    and attention's products, 4 B H Lq Lk D per call.  Each forward FLOP
    counts once for the forward, twice for the backward and, with full
    remat, once more inside the blocks for their recompute.  Biases,
    norms, elementwise work, the VAE and T5 are not counted."""
    from torch import nn

    from ezaudio_tpu_torch.models.blocks import Attention

    total = 0.0
    for name, mod in model.named_modules():
        times = 4 if remat and ("_blocks." in name or "mid_block." in name) else 3
        if isinstance(mod, (nn.Linear, nn.modules.conv._ConvNd)):
            seen = (text_len if any(s in name for s in TEXT_LINEARS)
                    else 1 if any(s in name for s in SAMPLE_LINEARS) else frames)
            total += times * 2.0 * mod.weight.numel() * batch * seen
        elif isinstance(mod, Attention):
            keys = text_len if name.endswith("cross_attn") else frames
            total += times * 4.0 * batch * mod.num_heads * frames * keys * mod.head_dim
    return total


def training_path(dev="cuda", cfg=None, clips=16, batch=TRAIN_BATCH, seconds=10.0, steps=6,
                  resume_at=4, sr=24000, t5_config=None, vae_config=None, dtype="float32"):
    """Phase 24 (``dtype`` bfloat16: phase 28): ``train_cli.main`` on a
    seeded dataset of ``clips`` clips, batch ``batch``, ``steps`` steps,
    warmup 2, CFG dropout 0.1, the model config's remat, ``--dtype``; the
    per-step launches checked, every one in ``dtype``.  Then the trainer
    is deleted, the checkpoint after ``steps`` removed, and a restart from
    step ``resume_at`` must give the uninterrupted run's last losses."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.models.udit import resolve_remat_policy
    from ezaudio_tpu_torch.training import train_cli

    cfg = cfg if cfg is not None else get_model_config("s3_l").to_dict()
    m = cfg["model"]
    want_attn = train_attention_launches(m)
    cuda = torch.device(dev).type == "cuda"
    frames = int(seconds * cfg["autoencoder"]["latent_sr"])
    root = tempfile.mkdtemp(prefix="ezaudio_train_")
    try:
        meta = write_training_set(root, clips, seconds, sr)
        path = training_config(root, cfg, meta, batch, seconds, sr)

        def run(max_steps, record):
            state = {"t": None}
            shapes = set()

            def on_step(step, metrics):
                sync(dev)
                now = time.perf_counter()
                attn, res = read_counters()
                record.append(dict(step=step, loss=metrics["loss"].item(),
                                   grad_norm=metrics["grad_norm"].item(),
                                   wall_s=now - state["t"], attention_launches=attn,
                                   resunit_launches=res,
                                   launches_by_dtype=read_dtype_counters()))
                reset_counters()
                state["t"] = time.perf_counter()

            argv = ["--config-name", path, "--max-steps", str(max_steps),
                    "--save-every-step", str(resume_at), "--log-step", "1",
                    "--log-dir", os.path.join(root, "logs"),
                    "--save-dir", os.path.join(root, "ckpts"), "--random-seed", "0",
                    "--dtype", dtype]
            if not cuda:
                argv += ["--device", dev]
            with resunit_shapes(shapes, full=True):
                reset_counters()
                state["t"] = time.perf_counter()
                trainer = train_cli.main(argv, t5_config=t5_config, vae_config=vae_config,
                                         on_step=on_step)
            n = sum(p.numel() for p in trainer.model.parameters())
            udit = trainer.model.model
            flops = train_flops(trainer.model, batch, frames, cfg["text_encoder"]["max_length"],
                                remat=udit.use_checkpoint
                                and resolve_remat_policy(udit.remat_policy) == "full")
            faults = mixed_precision_faults(trainer) if dtype == "bfloat16" else []
            del trainer  # its memory is checked back by the caller
            return n, flops, shapes, faults

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        first, resumed = [], []
        n_params, flops, shapes, faults = run(steps, first)
        peak = mem_gib(torch.cuda.max_memory_allocated) if cuda else None
        shutil.rmtree(os.path.join(root, "ckpts", cfg.get("model_name", "model"), str(steps)))
        run(steps, resumed)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    walls = [r["wall_s"] for r in first[1:]]
    wall = statistics.median(walls)
    row = dict(path="train" if dtype == "float32" else f"train_{dtype}",
               card=card_line() if cuda else "cpu", batch=batch, clip_s=seconds,
               steps=steps, dtype=dtype, dit_params=n_params,
               step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in first],
               samples_per_s=batch / wall, audio_s_per_s=batch * seconds / wall,
               flops_per_step=flops, flop_rule="train_flops: per module, by the tokens each sees",
               model_tflops=flops / wall / 1e12,
               share_of_peak=flops / wall / PEAK_FLOPS[dtype], peak_mem_gib=peak,
               mixed_precision_faults=faults,
               losses=[r["loss"] for r in first], grad_norms=[r["grad_norm"] for r in first],
               resumed_losses=[r["loss"] for r in resumed],
               launches_per_step=[[r["attention_launches"], r["resunit_launches"]] for r in first],
               resunit_batch_shapes=sorted(shapes))
    log("train " + json.dumps(row))
    want_dtype = want_by_dtype(want_attn, 12, dtype)
    if faults:
        raise AssertionError(f"train {dtype}: mixed precision faults {faults[:4]}")
    for r in first + resumed:
        if (r["attention_launches"], r["resunit_launches"]) != (want_attn, 12):
            raise AssertionError(f"train step {r['step']}: launches {r['attention_launches']}, "
                                 f"{r['resunit_launches']}: want {want_attn}, 12")
        if r["launches_by_dtype"] != want_dtype:
            raise AssertionError(f"train step {r['step']}: launches by dtype "
                                 f"{r['launches_by_dtype']}, want {want_dtype}")
    if len(first) != steps or not np.isfinite(row["losses"]).all():
        raise AssertionError(f"train: losses {row['losses']}")
    if [r["step"] for r in resumed] != list(range(resume_at + 1, steps + 1)):
        raise AssertionError(f"train: the restart ran steps {[r['step'] for r in resumed]}")
    tail = np.array(row["losses"][resume_at:])
    if not np.allclose(row["resumed_losses"], tail, rtol=RESUME_REL_TOL, atol=0):
        raise AssertionError(f"train: resumed losses {row['resumed_losses']}, want {tail}")
    tag = () if dtype == "float32" else (dtype,)
    row.update(attention_launches=sum(r["attention_launches"] for r in first + resumed),
               resunit_launches=sum(r["resunit_launches"] for r in first + resumed),
               resunit_shapes=sorted({s[1:3] + tag for s in shapes}, reverse=True))
    return row


def train_step_card_vs_cpu(gen, dev="cuda", cfg=None, batch=2, text_len=100,
                           policies=("full", "dots", "off")):
    """Phase 25: one train step on the card under each remat policy of
    ``policies`` and one on the CPU (full remat), all from the same
    weights, batch and draws (s3_l widths, depth 2).  Each card step is
    held to the CPU's: loss, grad norm, every gradient, every updated
    parameter, the attention launches its policy implies, and a non-zero
    gradient on the q, k and v projections of every attention."""
    import copy

    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.trainer import Trainer

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    cfg = copy.deepcopy(cfg)
    m = cfg["model"]
    schedule = DDIMSchedule.from_config(cfg["diff"])
    lr = 1e-4
    opt = dict(learning_rate=lr, warmup=0, grad_clip=1.0, weight_decay=0.01, snr_gamma=5.0)
    cpu_gen = torch.Generator().manual_seed(25)
    with torch.device(dev):
        first = maskdit_from_config(m)
    init_random_(first, gen)
    weights = {k: v.cpu() for k, v in first.state_dict().items()}
    del first
    frames, C = m["img_size"], m["out_chans"]
    ctx = m["context_dim"]
    text_mask = torch.ones(batch, text_len, dtype=torch.bool)
    text_mask[0, 23:] = False
    uncond_mask = torch.zeros(1, text_len, dtype=torch.bool)
    uncond_mask[0, :1] = True
    host = dict(latents=torch.randn(batch, frames, C, generator=cpu_gen),
                text=torch.randn(batch, text_len, ctx, generator=cpu_gen), text_mask=text_mask,
                uncond=torch.randn(1, text_len, ctx, generator=cpu_gen), uncond_mask=uncond_mask)

    def remat(policy):
        return dict(m, use_checkpoint=policy != "off",
                    remat_policy="full" if policy == "off" else policy)

    def step(policy, device):
        with torch.device(device):
            model = maskdit_from_config(remat(policy))
        model.load_state_dict(weights)
        trainer = Trainer.create(model.train(), schedule, opt)
        draws = trainer.step_fn.draw(torch.Generator().manual_seed(26), batch, frames, C, "cpu")
        draws["cfg"][:] = torch.tensor([0.05] + [0.9] * (batch - 1))  # one sample drops its text
        reset_counters()
        res = trainer.step_fn({k: v.to(device) for k, v in host.items()}, seed=0,
                              draws={k: v.to(device) for k, v in draws.items()},
                              return_grads=True)
        sync(device)
        return dict(loss=res["loss"].item(), grad_norm=res["grad_norm"].item(),
                    grads={k: v.cpu() for k, v in res["grads"].items()},
                    params={k: v.detach().cpu() for k, v in model.named_parameters()},
                    launches=read_counters())

    cpu = step("full", "cpu")
    rows, bad = [], []
    for policy in policies:
        row, failed = train_step_agreement(step(policy, dev), cpu, lr, m["depth"],
                                           train_attention_launches(remat(policy)),
                                           n_attn=attention_modules(m))
        row.update(path="train_step_card_vs_cpu", remat=policy, depth=m["depth"], batch=batch)
        log("train_card_vs_cpu " + json.dumps(row))
        rows.append(row)
        bad += [f"remat {policy}: {b}" for b in failed]
    if bad:
        raise AssertionError("train step, card against CPU: " + "; ".join(bad))
    return rows


def train_step_agreement(g: dict, c: dict, lr: float, depth: int, want_attn: int,
                         n_attn=None, zero_names=()):
    """Phase 25's limits on the card's step ``g`` against the CPU's ``c``
    (each: ``loss``, ``grad_norm``, ``grads``, updated ``params`` and the
    card's ``launches``): ``(row, failures)``.  ``n_attn``: the attention
    modules with q/k/v gradients (default: a MaskDiT's, 2 (depth + 1));
    ``zero_names``: gradients 0 in exact arithmetic, held to
    ZERO_GRAD_TOL instead (see there)."""
    n_attn = 2 * (depth + 1) if n_attn is None else n_attn
    largest = max(v.abs().max().item() for v in c["grads"].values())
    noise = {n: max(g["grads"][n].abs().max().item(), c["grads"][n].abs().max().item())
             for n in zero_names}
    ok_grads, rows = grad_agreement({n: v for n, v in g["grads"].items() if n not in noise},
                                    {n: v for n, v in c["grads"].items() if n not in noise},
                                    TRAIN_GRAD_TOL, GRAD_FLOOR)
    worst = max(rows, key=lambda n: rows[n]["rel_err"])
    qkv = qkv_grads_nonzero(g["grads"])
    param_err, stable_err = 0.0, 0.0  # the latter in units of its limit
    for n, p in g["params"].items():
        d = (p - c["params"][n]).abs()
        param_err = max(param_err, d.max().item())
        stable = c["grads"][n].abs() > ADAM_STABLE_GRAD
        if stable.any():
            limit = 1e-3 * lr + 2.0 ** -22 * c["params"][n].abs()
            stable_err = max(stable_err, (d / limit)[stable].max().item())
    row = dict(loss=[g["loss"], c["loss"]], grad_norm=[g["grad_norm"], c["grad_norm"]],
               worst_grad=dict(rows[worst], name=worst), n_grads=len(rows),
               param_max_abs_err=param_err, param_stable_err_share_of_limit=stable_err, lr=lr,
               qkv_grads=len(qkv), qkv_min_grad=min(qkv.values(), default=0.0),
               zero_grads_share_of_largest=max(noise.values(), default=0.0) / largest,
               launches=list(g["launches"]), want_attention_launches=want_attn)
    bad = []
    if not abs(g["loss"] - c["loss"]) <= TRAIN_REL_TOL * abs(c["loss"]):
        bad.append("loss")
    if not abs(g["grad_norm"] - c["grad_norm"]) <= TRAIN_REL_TOL * c["grad_norm"]:
        bad.append("grad_norm")
    if not ok_grads:
        bad.append("gradients " + str(sorted(n for n, r in rows.items()
                                             if r["zero"] or not r["rel_err"] <= TRAIN_GRAD_TOL)))
    if not (param_err <= 2 * lr and stable_err <= 1.0):
        bad.append("updated parameters")
    if any(v > ZERO_GRAD_TOL * largest for v in noise.values()):
        bad.append("zero gradients " + str(sorted(n for n, v in noise.items()
                                                   if v > ZERO_GRAD_TOL * largest)))
    if len(qkv) != 3 * n_attn or not min(qkv.values(), default=0.0) > 0:
        bad.append(f"q/k/v gradients {qkv}")
    if g["launches"][0] != want_attn:
        bad.append(f"attention launches {g['launches'][0]}, want {want_attn}")
    return row, bad


# ---------------------------------------------------------------------------
# The rest of training (phases 26-29): ControlNet fine-tuning, progressive
# distillation, bf16 mixed-precision training, rectified flow and the tools.
# One student DDIM step with v* from x_t lands on the teacher's two-step
# target: within this share of the target's largest magnitude (f32 algebra,
# x' = A x + B v* with v* = (x_target - A x) / B).
DISTILL_LAND_TOL = 1e-4
# bf16 gradients, card against CPU (and kernel 1's bf16 gradients against
# SDPA's): the statistical rule of tests/test_torch_bf16.py.  The card's
# gradients (one vector) no farther from the CPU's bf16 ones than
# BF16_REF_FACTOR times the CPU's bf16 distance from its f32 ones, and
# correlated above BF16_TRAIN_CORR; the loss, one scalar mean, within
# 2^-8 relative; the parameters' updates correlated above BF16_TRAIN_CORR.
BF16_TRAIN_CORR = 0.99
BF16_LOSS_REL = 2.0 ** -8
BF16_ATTN_GRAD_CORR = 0.999
BF16_TRAIN_OPTIMIZERS = (("adamw", {}), ("adamw_mu_bf16", dict(mu_dtype="bfloat16")),
                         ("adafactor", dict(optimizer="adafactor")))


def controlnet_train_launches(model_cfg: dict) -> int:
    """Attention launches of one ControlNet train step: the frozen base's
    depth + 1 blocks forward and, under remat, its depth // 2 out-blocks
    again in the backward (only they lie on the gradient's path: the skips
    enter there); the ControlNet's depth // 2 in-blocks (no remat); two
    attentions a block."""
    half = model_cfg["depth"] // 2
    recompute = half if model_cfg.get("use_checkpoint") else 0
    return 2 * (model_cfg["depth"] + 1 + recompute + half)


def distill_train_launches(model_cfg: dict) -> int:
    """Attention launches of one distillation step: the teacher's two CFG
    calls (each one call on the doubled batch, no grad) and the student's
    call, whose blocks remat recomputes in the backward."""
    blocks = model_cfg["depth"] + 1
    return 2 * blocks * (2 + (2 if model_cfg.get("use_checkpoint") else 1))


def snapshot(module):
    """A host copy of every parameter and buffer of ``module``."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def unchanged(module, before: dict) -> list:
    """The names whose bytes differ from ``before``'s."""
    import torch

    return [k for k, v in module.state_dict().items()
            if not torch.equal(v.detach().cpu(), before[k])]


def timed_steps(dev, n, fn):
    """``fn(i)`` for i < n with the counters set to 0 before each call and
    read after: per step (wall s, attention, resunit launches, by dtype,
    fn's result)."""
    rows = []
    for i in range(n):
        sync(dev)
        reset_counters()
        t0 = time.perf_counter()
        out = fn(i)
        sync(dev)
        rows.append(dict(wall_s=time.perf_counter() - t0, launches=list(read_counters()),
                         by_dtype=read_dtype_counters(), out=out))
    return rows


def controlnet_train_path(dev="cuda", cfg=None, batch=TRAIN_BATCH, seconds=10.0, steps=4,
                          sr=24000, lr=1e-4, t5_config=None, vae_config=None):
    """Phase 26: ControlNet fine-tuning of EzAudio-L-Energy: the frozen
    s3_l base and the ControlNet's trainable subset, ``batch`` seeded
    latents of ``seconds``, energy conditions of seeded clips, T5 on
    seeded captions, the config's remat, f32, ``steps`` steps.  The base
    and the ControlNet's frozen leaves keep their bytes, every trainable
    tensor moves, every zero block gets a non-zero gradient (F6), and each
    step launches what ``controlnet_train_launches`` says, all f32."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.controlnet import EzAudioControlNet
    from ezaudio_tpu_torch.models.controlnet import trainable_mask
    from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step

    cuda = torch.device(dev).type == "cuda"
    cn = EzAudioControlNet("energy", config=cfg, device=dev, seed=0, t5_config=t5_config,
                           vae_config=vae_config)
    base, m = cn.base, cn.base.params_cfg.model.to_dict()
    frames = int(seconds * base.latent_sr)
    gen = torch.Generator(device=dev).manual_seed(26)
    clips = np.stack([np.roll(burst_clip(sr, seconds), 997 * i) for i in range(batch)])
    # clones: the API embeds in inference mode, whose tensors autograd refuses
    condition = cn.conditioner(torch.from_numpy(clips).to(dev)).float().clone()
    text, text_mask = (t.clone() for t in base.embed_text(
        [PROMPTS[i % len(PROMPTS)] for i in range(batch)]))
    data = dict(latents=torch.randn(batch, frames, base.latent_dim, device=dev, generator=gen),
                condition=condition, text=text, text_mask=text_mask)
    base_before, cn_before = snapshot(base.dit), snapshot(cn.controlnet)
    step = make_controlnet_train_step(base.dit, cn.controlnet, base.noise_scheduler,
                                      learning_rate=lr, warmup=0, scale=base.scale,
                                      shift=base.shift)
    mask = trainable_mask(cn.controlnet)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    def run(i):
        # the step's own draws, with the first sample's condition masked:
        # mask_embed has a gradient only where a condition is masked
        draws = step.draw(torch.Generator(device=dev).manual_seed(260 + i), data)
        draws["select"][0] = 0.0
        return step(data, seed=0, draws=draws, return_grads=i == 0)

    rows = timed_steps(dev, steps, run)
    peak = mem_gib(torch.cuda.max_memory_allocated) if cuda else None
    grads = rows[0]["out"].pop("grads")
    zero_blocks = {n: g.abs().max().item() for n, g in grads.items()
                   if n.startswith("controlnet_zero_blocks.")}
    del grads
    moved_base = unchanged(base.dit, base_before)
    changed = set(unchanged(cn.controlnet, cn_before))
    frozen_moved = sorted(n for n in changed if n in mask and not mask[n])
    still = sorted(n for n, t in mask.items() if t and n not in changed)
    wall = statistics.median(r["wall_s"] for r in rows[1:]) if steps > 1 else rows[0]["wall_s"]
    want = controlnet_train_launches(m)
    row = dict(path="controlnet_train", card=card_line() if cuda else "cpu", batch=batch,
               clip_s=seconds, steps=steps, lr=lr,
               controlnet_params=sum(p.numel() for p in cn.controlnet.parameters()),
               trainable_params=sum(p.numel() for n, p in cn.controlnet.named_parameters()
                                    if mask[n]),
               base_params=sum(p.numel() for p in base.dit.parameters()),
               step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in rows],
               samples_per_s=batch / wall, peak_mem_gib=peak,
               losses=[r["out"]["loss"].item() for r in rows],
               grad_norms=[r["out"]["grad_norm"].item() for r in rows],
               launches_per_step=[r["launches"] for r in rows],
               zero_block_grad_min=min(zero_blocks.values(), default=0.0),
               base_tensors_changed=len(moved_base), frozen_tensors_changed=len(frozen_moved),
               trainable_tensors_unmoved=len(still))
    log("controlnet_train " + json.dumps(row))
    bad = []
    if moved_base or frozen_moved:
        bad.append(f"frozen tensors changed: {moved_base[:3]} {frozen_moved[:3]}")
    if still:
        bad.append(f"trainable tensors that did not move: {still[:5]}")
    if len(zero_blocks) != 2 * (m["depth"] // 2) or not min(zero_blocks.values(),
                                                            default=0.0) > 0:
        bad.append(f"zero block gradients {zero_blocks}")
    for i, r in enumerate(rows):
        if r["launches"] != [want, 0] or r["by_dtype"] != want_by_dtype(want, 0, "float32"):
            bad.append(f"step {i + 1} launches {r['launches']} {r['by_dtype']}, want {want}, 0")
    if not np.isfinite(row["losses"]).all():
        bad.append("losses")
    if bad:
        raise AssertionError("controlnet train: " + "; ".join(bad))
    row.update(attention_launches=sum(r["launches"][0] for r in rows),
               resunit_launches=sum(r["launches"][1] for r in rows), resunit_shapes=[])
    return row


def _step_row(res, params, launches):
    """A train step's result as ``train_step_agreement`` reads it."""
    from ezaudio_tpu_torch.training.optim import global_norm

    grads = {k: v.float().cpu() for k, v in res["grads"].items()}
    return dict(loss=res["loss"].item(), grad_norm=global_norm(grads.values()).item(),
                grads=grads, params={k: v.detach().cpu() for k, v in params.items()},
                launches=launches)


def controlnet_train_card_vs_cpu(gen, dev="cuda", cfg=None, batch=2, text_len=100):
    """Phase 26, second half: one ControlNet train step on the card and on
    the CPU from the same weights, batch and draws (the energy config at
    full width, depth 2): ``train_step_agreement``'s limits over the
    ControlNet's gradients and parameters, its q/k/v gradients non-zero."""
    import copy

    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.controlnet import controlnet_from_config, init_from_base_
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.controlnet_trainer import make_controlnet_train_step

    if cfg is None:
        cfg = get_model_config("energy").to_dict()
        cfg["model"]["depth"] = 2
    cfg = copy.deepcopy(cfg)
    m, lr = cfg["model"], 1e-4
    cpu_gen = torch.Generator().manual_seed(261)
    dit = init_random_(maskdit_from_config(m), cpu_gen)
    cn = init_random_(controlnet_from_config(m, cfg["controlnet"]), cpu_gen)
    init_from_base_(cn, dit.model)
    weights = (dit.state_dict(), cn.state_dict())
    frames = m["img_size"]
    text_mask = torch.ones(batch, text_len, dtype=torch.bool)
    text_mask[0, 23:] = False
    host = dict(latents=torch.randn(batch, frames, m["out_chans"], generator=cpu_gen),
                condition=torch.rand(batch, 2 * frames, cfg["controlnet"]["cond_in"],
                                     generator=cpu_gen),
                text=torch.randn(batch, text_len, m["context_dim"], generator=cpu_gen),
                text_mask=text_mask)
    schedule = DDIMSchedule.from_config(cfg["diff"])

    def step(device):
        with torch.device(device):
            d, c = maskdit_from_config(m), controlnet_from_config(m, cfg["controlnet"])
        d.load_state_dict(weights[0])
        c.load_state_dict(weights[1])
        fn = make_controlnet_train_step(d, c, schedule, learning_rate=lr, warmup=0, snr_gamma=5.0)
        draws = fn.draw(torch.Generator().manual_seed(262), host)
        draws["select"][:] = torch.tensor([0.1] + [0.9] * (batch - 1))  # one sample masked
        reset_counters()
        res = fn({k: v.to(device) for k, v in host.items()}, seed=0,
                 draws={k: v.to(device) for k, v in draws.items()}, return_grads=True)
        sync(device)
        return _step_row(res, dict(c.named_parameters()), read_counters())

    cpu = step("cpu")
    want = controlnet_train_launches(m)
    row, bad = train_step_agreement(step(dev), cpu, lr, m["depth"], want,
                                    n_attn=2 * (m["depth"] // 2),
                                    zero_names=[n for n in cpu["grads"]
                                                if n.endswith("cross_attn.norm_k.bias")])
    row.update(path="controlnet_train_card_vs_cpu", depth=m["depth"], batch=batch)
    log("controlnet_train_card_vs_cpu " + json.dumps(row))
    if bad:
        raise AssertionError("controlnet train step, card against CPU: " + "; ".join(bad))
    return row


def _distill_fns(guidance):
    """The student (single batch, no CFG) and the CFG teacher of
    scripts/distill_validate.py: cond and zero context on the doubled batch."""
    import torch

    def builder(batch, teacher):
        def fn(x, t):
            ctx = torch.cat([batch["text"], torch.zeros_like(batch["text"])])
            out, _ = teacher(torch.cat([x, x]), torch.cat([t, t]), ctx)
            cond, unc = out.chunk(2)
            return unc + guidance * (cond - unc)
        return fn

    def student_apply(student):
        return lambda x, t, batch: student(x, t, batch["text"])[0]

    return builder, student_apply


def distill_land_error(step, data, gen) -> float:
    """One student DDIM step with ``v*`` from ``x_t``, against the
    teacher's two-step target: max error over max |target|."""
    import torch

    from ezaudio_tpu_torch.diffusion import distill

    d = step.draw(gen, data["latents"])
    x0, m = data["latents"].float(), d["m"]
    a = distill._table(step.tables.a_t, m, x0)
    a_prev = distill._table(step.tables.a_prev, m, x0)
    x_t = a.sqrt() * x0 + (1.0 - a).sqrt() * d["eps"]
    with torch.no_grad():
        target = distill.teacher_two_step_target(step.builder(data, step.teacher), step.schedule,
                                                 x_t, m, step.tables)
    v_star = distill.v_target_from_endpoint(x_t, target, a, a_prev)
    land = step.schedule.ddim_step(v_star, x_t, a, a_prev)
    return ((land - target).abs().max() / target.abs().max()).item()


def distill_path(ez, batch=4, seconds=10.0, steps=4, n_student=8, guidance=5.0, lr=1e-4):
    """Phase 27: one progressive-distillation stage on ``ez``'s DiT (the student,
    a deep copy of the teacher, takes ``n_student`` steps for the teacher's
    2 ``n_student``; CFG ``guidance`` folded in), ``batch`` seeded latents
    of ``seconds`` with T5 on seeded captions, ``steps`` steps; the
    landing check, the teacher's bytes unchanged, the launches of each
    step.  Then the student serves ``generate_audio(sampler='distilled')``
    for 10 s: ``n_student`` model calls and the decode."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.diffusion import distill
    from ezaudio_tpu_torch.training.optim import make_optimizer

    dev = ez.device
    cuda = dev.type == "cuda"
    m = ez.params_cfg.model.to_dict()
    teacher = ez.dit
    student = distill.student_from_teacher(teacher)
    builder, student_apply = _distill_fns(guidance)
    step = distill.make_distill_step(student_apply(student), builder, ez.noise_scheduler,
                                     make_optimizer(student, learning_rate=lr, warmup=0),
                                     distill.distill_tables(ez.noise_scheduler, n_student),
                                     teacher=teacher)
    frames = int(seconds * ez.latent_sr)
    gen = torch.Generator(device=dev).manual_seed(27)
    text = ez.embed_text([PROMPTS[i % len(PROMPTS)] for i in range(batch)])[0].clone()
    data = dict(latents=torch.randn(batch, frames, ez.latent_dim, device=dev, generator=gen),
                text=text)
    land = distill_land_error(step, data, gen)
    before = snapshot(teacher)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rows = timed_steps(dev, steps, lambda i: step(data, seed=0))
    peak = mem_gib(torch.cuda.max_memory_allocated) if cuda else None
    moved = unchanged(teacher, before)
    student_moved = sum(not torch.equal(p.detach().cpu(), before[n])
                        for n, p in student.state_dict().items())
    want = distill_train_launches(m)
    wall = statistics.median(r["wall_s"] for r in rows[1:]) if steps > 1 else rows[0]["wall_s"]
    ez.dit = student.eval()
    n_res = sum(isinstance(x, ResidualUnit) for x in ez.autoencoder.model.decoder.modules())
    n_samples = int(seconds * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    served = run_path("distilled_student", dev,
                      lambda: ez.generate_audio(PROMPTS[0], length=seconds, sampler="distilled",
                                                ddim_steps=n_student, random_seed=7)[1],
                      2 * (m["depth"] + 1) * n_student, n_res, seconds, n_samples,
                      dtype="float32")
    served.pop("wav")
    ez.dit = teacher
    row = dict(path="distill_train", card=card_line() if cuda else "cpu", batch=batch,
               clip_s=seconds, steps=steps, student_steps=n_student,
               teacher_steps=2 * n_student, guidance=guidance, lr=lr,
               land_rel_err=land, land_tol=DISTILL_LAND_TOL,
               step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in rows],
               samples_per_s=batch / wall, peak_mem_gib=peak,
               losses=[r["out"]["loss"].item() for r in rows],
               launches_per_step=[r["launches"] for r in rows],
               teacher_tensors_changed=len(moved), student_tensors_moved=student_moved,
               served=served)
    log("distill_train " + json.dumps(row))
    bad = []
    if not land <= DISTILL_LAND_TOL:
        bad.append(f"v* lands {land} from the target")
    if moved or not student_moved:
        bad.append(f"teacher changed {moved[:3]}, student moved {student_moved}")
    for i, r in enumerate(rows):
        if r["launches"] != [want, 0] or r["by_dtype"] != want_by_dtype(want, 0, "float32"):
            bad.append(f"step {i + 1} launches {r['launches']}, want {want}, 0")
    if not np.isfinite(row["losses"]).all():
        bad.append("losses")
    if bad:
        raise AssertionError("distill: " + "; ".join(bad))
    row.update(attention_launches=sum(r["launches"][0] for r in rows)
               + served["attention_launches"],
               resunit_launches=served["resunit_launches"],
               resunit_shapes=served["resunit_shapes"])
    return row


def distill_card_vs_cpu(gen, dev="cuda", cfg=None, batch=2, text_len=100, n_student=8,
                        guidance=5.0):
    """Phase 27, second half: one distillation step on the card and on the
    CPU from the same weights, batch and draws (s3_l at full width, depth
    2): ``train_step_agreement``'s limits over the student."""
    import copy

    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion import distill
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.optim import make_optimizer

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    cfg = copy.deepcopy(cfg)
    m, lr = cfg["model"], 1e-4
    cpu_gen = torch.Generator().manual_seed(271)
    weights = init_random_(maskdit_from_config(m), cpu_gen).state_dict()
    host = dict(latents=torch.randn(batch, m["img_size"], m["out_chans"], generator=cpu_gen),
                text=torch.randn(batch, text_len, m["context_dim"], generator=cpu_gen))
    schedule = DDIMSchedule.from_config(cfg["diff"])
    builder, student_apply = _distill_fns(guidance)

    def step(device):
        with torch.device(device):
            teacher = maskdit_from_config(m)
        teacher.load_state_dict(weights)
        student = distill.student_from_teacher(teacher)
        fn = distill.make_distill_step(student_apply(student), builder, schedule,
                                       make_optimizer(student, learning_rate=lr, warmup=0),
                                       distill.distill_tables(schedule, n_student),
                                       teacher=teacher)
        draws = fn.draw(torch.Generator().manual_seed(272), host["latents"])
        reset_counters()
        res = fn({k: v.to(device) for k, v in host.items()}, seed=0,
                 draws={k: v.to(device) for k, v in draws.items()}, return_grads=True)
        sync(device)
        return _step_row(res, dict(student.named_parameters()), read_counters())

    cpu = step("cpu")
    row, bad = train_step_agreement(step(dev), cpu, lr, m["depth"], distill_train_launches(m),
                                    zero_names=[n for n in cpu["grads"]
                                                if n.endswith("cross_attn.norm_k.bias")])
    row.update(path="distill_card_vs_cpu", depth=m["depth"], batch=batch)
    log("distill_card_vs_cpu " + json.dumps(row))
    if bad:
        raise AssertionError("distill step, card against CPU: " + "; ".join(bad))
    return row


def mixed_precision_faults(trainer, mu_dtype=None) -> list:
    """The bf16 trainer's invariants: the step computes in bf16, the
    parameters stay f32, and so does every optimizer state tensor but a
    first moment kept in ``mu_dtype``."""
    import torch

    faults = [] if trainer.step_fn.dtype == torch.bfloat16 else ["compute dtype"]
    faults += [n for n, p in trainer.model.named_parameters() if p.dtype != torch.float32]
    mu = torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32

    def walk(obj, key=""):
        if isinstance(obj, torch.Tensor):
            want = mu if key in ("mu", "ema") else torch.float32
            if obj.is_floating_point() and obj.dtype != want:
                faults.append(f"optimizer {key} {obj.dtype}")
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, k if k in ("mu", "ema") else key)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v, key)

    walk(trainer.optimizer.rule.state_dict())
    return faults


def bf16_agreement_stats(got, want, ref):
    """``(d_got, d_ref, corr)``: max |got - want|, max |want - ref| and the
    correlation of got with want, over flat f32 copies."""
    import torch

    got, want, ref = (t.detach().float().cpu().ravel() for t in (got, want, ref))
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    return (got - want).abs().max().item(), (want - ref).abs().max().item(), corr


def check_attention_grad_bf16(dev, gen, cases=ATTN_GRAD_CASES):
    """Phase 28: kernel 1's bf16 autograd gradients (the kernel forward,
    the plain twin's vjp at the bf16 inputs) held against SDPA's bf16
    gradients by the statistical rule: no farther from the f32 gradients
    (the plain twin's at the same inputs in f32) than BF16_REF_FACTOR times
    SDPA's distance, correlated with SDPA's above BF16_ATTN_GRAD_CORR."""
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention

    rows = []
    for (B, H, Lq, Lk, D, masked) in cases:
        q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen) for L in (Lq, Lk, Lk))
        g = torch.randn(B, H, Lq, D, device=dev, generator=gen)
        mask = key_mask(B, Lk, masked, dev)
        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def grads(fn, dtype):
            ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            out = fn(*ins)
            return out, ins, dict(zip("qkv", torch.autograd.grad(out, ins, g.to(dtype),
                                                                 retain_graph=True)))

        o, ins, got = grads(lambda *a: fused_attention(*a, key_mask=mask), torch.bfloat16)
        if o.grad_fn is None or type(o.grad_fn).__name__ != "FusedAttentionBackward":
            raise AssertionError(f"bf16 attention {B, H, Lq, Lk, D}: no kernel grad_fn")
        sdpa_fn = lambda *a: F.scaled_dot_product_attention(*a, attn_mask=sdpa_mask)  # noqa
        _, _, sdpa = grads(sdpa_fn, torch.bfloat16)
        g16 = g.to(torch.bfloat16)
        # the bf16 backward (the plain twin's recompute and vjp) and SDPA's
        # bf16 forward + backward, timed on the card; the bound as phase
        # 23's at bf16's rate
        bwd_ms = lib_ms = None
        if torch.device(dev).type == "cuda":
            bwd_ms = time_ms(lambda: torch.autograd.grad(o, ins, g16, retain_graph=True),
                             reps=3, iters=3)
            lib_ms = time_ms(lambda: torch.autograd.grad(sdpa_fn(*ins), ins, g16),
                             reps=3, iters=3)
        nbytes = 2 * (2 * Lq + 2 * Lk) * B * H * D * 2 + (B * Lk if masked else 0)
        bms, by = bound_ms(nbytes, 10.0 * B * H * Lq * Lk * D, "bfloat16")
        _, _, ref = grads(lambda *a: attention_plain(*a, key_mask=mask), torch.float32)
        sync(dev)
        stats = {}
        for n in "qkv":
            d_kernel = (got[n].float() - ref[n]).abs().max().item()
            d_sdpa = (sdpa[n].float() - ref[n]).abs().max().item()
            corr = bf16_agreement_stats(got[n], sdpa[n], ref[n])[2]
            stats[n] = dict(kernel_to_f32=d_kernel, sdpa_to_f32=d_sdpa, corr_with_sdpa=corr,
                            ok=d_kernel <= BF16_REF_FACTOR * d_sdpa
                            and corr > BF16_ATTN_GRAD_CORR)
        row = dict(kind="attention_backward_bf16", shape=[B, H, Lq, Lk, D], masked=masked,
                   grads=stats, backward_ms=bwd_ms, bound_ms=bms, bound_by=by,
                   library_fwd_bwd_ms=lib_ms, grad_fn=type(o.grad_fn).__name__)
        log("attention_grad_bf16 " + json.dumps(row))
        if not all(s["ok"] for s in stats.values()):
            raise AssertionError(f"bf16 attention gradients {row['shape']}: {stats}")
        rows.append(row)
    return rows


def bf16_train_card_vs_cpu(gen, dev="cuda", cfg=None, batch=2, text_len=100,
                           optimizers=BF16_TRAIN_OPTIMIZERS):
    """Phase 28, second half: one bf16 mixed-precision train step under
    each optimizer of ``optimizers``, on the card and on the CPU, and one
    f32 step on the CPU, from the same weights, bf16 batch and draws (s3_l
    at full width, depth 2): the statistical rule (``BF16_*``) on the
    gradients, the loss and the parameters' updates; every launch bf16;
    ``mixed_precision_faults`` empty."""
    import copy

    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.trainer import Trainer

    if cfg is None:
        cfg = get_model_config("s3_l").to_dict()
        cfg["model"]["depth"] = 2
    cfg = copy.deepcopy(cfg)
    m, lr = cfg["model"], 1e-4
    schedule = DDIMSchedule.from_config(cfg["diff"])
    cpu_gen = torch.Generator().manual_seed(281)
    weights = init_random_(maskdit_from_config(m), cpu_gen).state_dict()
    frames, C, ctx = m["img_size"], m["out_chans"], m["context_dim"]
    text_mask = torch.ones(batch, text_len, dtype=torch.bool)
    text_mask[0, 23:] = False
    uncond_mask = torch.zeros(1, text_len, dtype=torch.bool)
    uncond_mask[0, :1] = True
    host = dict(latents=torch.randn(batch, frames, C, generator=cpu_gen).bfloat16(),
                text=torch.randn(batch, text_len, ctx, generator=cpu_gen).bfloat16(),
                text_mask=text_mask,
                uncond=torch.randn(1, text_len, ctx, generator=cpu_gen).bfloat16(),
                uncond_mask=uncond_mask)

    def step(device, dtype, opt_kw):
        with torch.device(device):
            model = maskdit_from_config(m)
        model.load_state_dict(weights)
        trainer = Trainer.create(model.train(), schedule,
                                 dict(learning_rate=lr, warmup=0, snr_gamma=5.0, **opt_kw),
                                 dtype=dtype)
        draws = trainer.step_fn.draw(torch.Generator().manual_seed(282), batch, frames, C, "cpu")
        draws["cfg"][:] = torch.tensor([0.05] + [0.9] * (batch - 1))
        reset_counters()
        res = trainer.step_fn({k: v.to(device, dtype if v.is_floating_point() else v.dtype)
                               for k, v in host.items()}, seed=0,
                              draws={k: v.to(device) for k, v in draws.items()},
                              return_grads=True)
        sync(device)
        names = sorted(res["grads"])
        return dict(loss=res["loss"].item(),
                    grads=torch.cat([res["grads"][n].float().cpu().ravel() for n in names]),
                    update=torch.cat([(p.detach().float().cpu() - weights[n]).ravel()
                                      for n, p in sorted(model.named_parameters())]),
                    faults=mixed_precision_faults(trainer, opt_kw.get("mu_dtype"))
                    if dtype == torch.bfloat16 else [],
                    launches=list(read_counters()), by_dtype=read_dtype_counters())

    ref = step("cpu", torch.float32, {})
    want = train_attention_launches(m)
    rows, bad = [], []
    for name, kw in optimizers:
        c, g = step("cpu", torch.bfloat16, kw), step(dev, torch.bfloat16, kw)
        d_card, d_ref, corr = bf16_agreement_stats(g["grads"], c["grads"], ref["grads"])
        upd_corr = bf16_agreement_stats(g["update"], c["update"], c["update"])[2]
        row = dict(path="bf16_train_card_vs_cpu", optimizer=name, depth=m["depth"], batch=batch,
                   loss=[g["loss"], c["loss"], ref["loss"]], grad_card_to_cpu=d_card,
                   grad_cpu_bf16_to_f32=d_ref, grad_corr=corr, update_corr=upd_corr,
                   faults=g["faults"] + c["faults"], launches=g["launches"],
                   by_dtype=g["by_dtype"])
        log("bf16_train_card_vs_cpu " + json.dumps(row))
        if not (d_card <= BF16_REF_FACTOR * d_ref and corr > BF16_TRAIN_CORR):
            bad.append(f"{name}: gradients {d_card} vs {d_ref}, corr {corr}")
        if not abs(g["loss"] - c["loss"]) <= BF16_LOSS_REL * abs(c["loss"]):
            bad.append(f"{name}: loss {g['loss']} vs {c['loss']}")
        if not upd_corr > BF16_TRAIN_CORR:
            bad.append(f"{name}: updates correlate {upd_corr}")
        if row["faults"]:
            bad.append(f"{name}: mixed precision {row['faults'][:4]}")
        if g["launches"][0] != want or g["by_dtype"] != want_by_dtype(want, 0, "bfloat16"):
            bad.append(f"{name}: launches {g['by_dtype']}, want {want} bf16")
        rows.append(row)
    if bad:
        raise AssertionError("bf16 train step, card against CPU: " + "; ".join(bad))
    return rows


def flow_paths(ez, batch=4, seconds=10.0, steps=10, lr=1e-4, guidance=5.0, rescale=0.75):
    """Phase 29, flow: one ``flow_matching_loss`` train step of a copy of
    ``ez``'s DiT (``batch`` seeded latents, the MAE training branch, AdamW)
    and a ``steps``-step Heun ``flow_sample`` with CFG and rescale on one
    prompt, decoded; each run's launches."""
    import copy

    import torch

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.diffusion.flow import FlowSchedule, flow_matching_loss, flow_sample
    from ezaudio_tpu_torch.ops.quant import quant_context
    from ezaudio_tpu_torch.training.optim import make_optimizer, named_grads
    from ezaudio_tpu_torch.utils import scale_shift_re

    dev, m = ez.device, ez.params_cfg.model.to_dict()
    frames = int(seconds * ez.latent_sr)
    gen = torch.Generator(device=dev).manual_seed(29)
    sched = FlowSchedule()
    text, text_mask = (t.clone() for t in ez.embed_text(
        [PROMPTS[i % len(PROMPTS)] for i in range(batch)]))
    model = copy.deepcopy(ez.dit).train().requires_grad_(True)
    opt = make_optimizer(model, learning_rate=lr, warmup=0)
    x0 = torch.randn(batch, frames, ez.latent_dim, device=dev, generator=gen)
    noise = torch.randn(x0.shape, device=dev, generator=gen)
    t = torch.rand(batch, device=dev, generator=gen)
    draws = model.draw_mask(gen, batch, frames, dev)

    def train():
        with quant_context("off"):
            loss = flow_matching_loss(
                lambda xt, ts: model(xt, ts, text, context_mask=text_mask, gt=x0,
                                     mask_draws=draws), x0, noise, t, schedule=sched)
            opt.update(named_grads(opt.params.items(), loss))
        return loss.detach()

    (tr,) = timed_steps(dev, 1, lambda i: train())
    want_train = train_attention_launches(m)
    del model, opt
    cond, cmask = ez.embed_text([PROMPTS[0]])
    uncond, umask = ez._uncond_embedding(1)
    ctx, ctx_mask = torch.cat([cond, uncond]), torch.cat([cmask, umask])

    @torch.no_grad()
    def sample():
        z = flow_sample(lambda x, ts: ez.dit(x, ts, ctx[:x.shape[0]],
                                             context_mask=ctx_mask[:x.shape[0]])[0],
                        sched, torch.randn(1, frames, ez.latent_dim, device=dev, generator=gen),
                        steps, guidance_scale=guidance, guidance_rescale=rescale, method="heun")
        return ez._decode(scale_shift_re(z, ez.scale, ez.shift))

    n_res = sum(isinstance(x, ResidualUnit) for x in ez.autoencoder.model.decoder.modules())
    n_samples = frames * ez.autoencoder.downsampling_ratio
    row = run_path("flow_heun_cfg", dev, sample, 2 * steps * 2 * (m["depth"] + 1), n_res,
                   seconds, n_samples, dtype="float32")
    row.pop("wav")
    train_row = dict(path="flow_train", batch=batch, clip_s=seconds, loss=tr["out"].item(),
                     wall_s=tr["wall_s"], attention_launches=tr["launches"][0],
                     resunit_launches=tr["launches"][1], launches_by_dtype=tr["by_dtype"],
                     resunit_shapes=[])
    log("flow_train " + json.dumps(train_row))
    if (tr["launches"] != [want_train, 0] or not torch.isfinite(tr["out"])
            or tr["by_dtype"] != want_by_dtype(want_train, 0, "float32")):
        raise AssertionError(f"flow train step: {train_row}")
    return [train_row, row]


def tool_paths(ez, root, clips=16, seconds=10.0, batch=TRAIN_BATCH, t5_config=None,
               vae_config=None):
    """Phase 29, the tools: ``eval_udit`` in MAE mode on one seeded clip
    (kernel 2's encode and decode; the sampler at its defaults), then
    ``prepare_embeddings`` on phase 24's manifest and one ``train_cli`` step
    from those files (batch 8)."""
    import csv

    import numpy as np

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav
    from ezaudio_tpu_torch.training import evaluate, prepare_embeddings, train_cli

    dev, m = ez.device, ez.params_cfg.model.to_dict()
    val = os.path.join(root, "val")
    os.makedirs(val, exist_ok=True)
    save_wav(os.path.join(val, "0.wav"), seeded_clip(ez.sr, seconds), ez.sr)
    with open(os.path.join(val, "meta.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["audio_path", "caption", "split", "audio_length"])
        w.writeheader()
        w.writerow(dict(audio_path="0.wav", caption=PROMPTS[1], split="val",
                        audio_length=seconds))
    vae = ez.autoencoder.model
    n_enc, n_dec = (sum(isinstance(x, ResidualUnit) for x in part.modules())
                    for part in (vae.encoder, vae.decoder))
    steps = 50  # eval_udit's default; it renders 10 s
    row = run_path("eval_udit_mae", dev,
                   lambda: load_wav(evaluate.eval_udit(
                       ez, os.path.join(val, "meta.csv"), "val", audio_dir=val, mae=True,
                       save_path=os.path.join(root, "eval"), val_num=1)[0])[None],
                   steps * 2 * (m["depth"] + 1), n_enc + n_dec, 10.0,
                   int(10 * ez.sr), dtype="float32")
    row.pop("wav")
    rows = [row]

    meta = write_training_set(os.path.join(root, "train"), clips, seconds, ez.sr)
    emb = os.path.join(root, "emb")
    t0 = time.perf_counter()
    n = prepare_embeddings.prepare(ez, meta, emb, "train", batch_size=batch)
    prep_s = time.perf_counter() - t0
    if n != clips or len(os.listdir(emb)) != clips + 1:
        raise AssertionError(f"prepare_embeddings wrote {n} clips: {sorted(os.listdir(emb))}")
    cfg = json.loads(json.dumps(ez.params_cfg.to_dict()))
    path = training_config(os.path.join(root, "train"), cfg, meta, batch, seconds, ez.sr)
    with open(path) as f:
        cfg = json.load(f)
    cfg["data"]["train"].update(text_path=emb, uncond_path=os.path.join(emb, "uncond.npz"),
                                cfg_prob=0.1)
    with open(path, "w") as f:
        json.dump(cfg, f)
    record = []

    def on_step(step, metrics):
        sync(dev)
        record.append(dict(loss=metrics["loss"].item(), launches=list(read_counters()),
                           by_dtype=read_dtype_counters()))

    argv = ["--config-name", path, "--max-steps", "1", "--log-dir", os.path.join(root, "logs"),
            "--save-dir", os.path.join(root, "ckpts"), "--random-seed", "0"]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    seen = set()
    reset_counters()
    with resunit_shapes(seen):
        trainer = train_cli.main(argv, t5_config=t5_config, vae_config=vae_config,
                                 on_step=on_step)
    del trainer
    want = train_attention_launches(cfg["model"])
    offline = dict(path="train_offline_embeddings", prepare_s=prep_s, clips=n,
                   loss=record[0]["loss"] if record else None,
                   attention_launches=record[0]["launches"][0] if record else 0,
                   resunit_launches=record[0]["launches"][1] if record else 0,
                   resunit_shapes=sorted(seen, reverse=True))
    log("train_offline_embeddings " + json.dumps(offline))
    if (len(record) != 1 or record[0]["launches"] != [want, n_enc]
            or not np.isfinite(record[0]["loss"])
            or record[0]["by_dtype"] != want_by_dtype(want, n_enc, "float32")):
        raise AssertionError(f"train from offline embeddings: {record}")
    return rows + [offline]



# ---------------------------------------------------------------------------
# Codecs (phase 30): vae.json's widths, and the cut widths of the codec
# step's card-against-CPU run.
VAE_WIDTHS = dict(channels=128, latent_dim=128, c_mults=(1, 2, 4, 8), strides=(2, 4, 6, 10))
VAE_CUT = dict(channels=128, latent_dim=128, c_mults=(1, 2), strides=(2, 4))
# The codec step, card against CPU (the cut widths).  At random weights
# the generator's gradient is ill-conditioned in f32 (log10 STFT
# magnitudes, snake alphas summed over time): tests/test_torch_codec_training.py
# reads the JAX package's own f32 gradients up to 2.8e-2 of a tensor's
# scale from its float64 ones.  So each card step is held against the
# CPU's f32 step, with the CPU's float64 step (which that test holds
# against JAX's float64 step within 1e-8 of scale) as the witness:
#   * every loss term within CODEC_LOSS_REL of the CPU's;
#   * each gradient within TRAIN_GRAD_TOL of its scale (its largest entry,
#     or CODEC_GRAD_FLOOR times its network's largest where that is more)
#     from the CPU's, or no farther from float64 than the factor times the
#     CPU's gradient plus TRAIN_GRAD_TOL of its scale; each network's
#     gradient as one vector no farther from float64 (L2) than the factor
#     times the CPU's;
#   * the factor: CODEC_CUDNN_FACTOR for the card's step with the plain
#     twin in the kernel's place (cuDNN's f32 convolutions, TF32 off, sum
#     in other orders than the CPU's), CODEC_CUDNN_FACTOR times
#     CODEC_KERNEL_FACTOR for the step as it runs (kernel 2's forward is
#     3xTF32, within RESUNIT_TOL of the plain twin, not at f32's
#     rounding).  Each is twice the worst reading (H100, PERF.md section
#     6, PR 10): the plain step needed 2.99 in a tensor and 2.08 in L2,
#     the step as it runs 13.3 and 7.30 (4.45 times the plain step's);
#   * a LeakyReLU input of the discriminator whose sign differs between
#     the card and the CPU (``leaky_flips``) moves the gradients of its
#     chain of convs and of the sub-discriminator's ``conv_post`` by the
#     slope's jump, 0.9 times what passes through it: there the floor is
#     CODEC_KINK_FLOOR, where such a flip is shown in the run;
#   * the updated parameters: within 2 lr everywhere, and within 1e-3 lr
#     where the float64 gradient exceeds 1e-4 and four times each f32
#     gradient's distance from it.
CODEC_LOSS_REL = 1e-5
CODEC_CUDNN_FACTOR = 6.0
CODEC_KERNEL_FACTOR = 4.5
CODEC_GRAD_FLOOR = 1e-4
CODEC_KINK_FLOOR = 1e-3
# DAC and EnCodec, card against CPU: the codes may differ only at near
# ties.  At a frame's first differing codebook the CPU's scores of its own
# code and the card's (DAC: cosine similarity; EnCodec: minus the squared
# distance over the residual's squared norm) are within CODEC_TIE; that
# frame's later codebooks are not compared.  z on the frames whose codes all
# agree, and the audio each side decodes from the CPU's codes, within
# CODEC_REL_TOL of the CPU output's largest magnitude (f32 sums in another
# order, TF32 off).
CODEC_TIE = 1e-4
CODEC_REL_TOL = 1e-4


def codec_clip(sr: int, seconds: float, batch: int = 1, seed: int = 0):
    """Seeded clips (B, T, 1): two tones, a slow tremolo and noise, each
    clip its own pitch."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    clips = [(0.3 * np.sin(2 * np.pi * (220 + 37 * i) * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
              + 0.1 * np.sin(2 * np.pi * 1375 * t) + 0.03 * rng.standard_normal(t.shape))
             for i in range(batch)]
    return np.stack(clips)[..., None].astype(np.float32)


def build_codec(kind: str, dev, seed: int = 0, **kw):
    """A seeded codec or discriminator (``codec_trainer.init_codec_``) on
    ``dev``: drawn on the CPU, then copied, so every device holds the same
    weights for a seed."""
    import torch

    from ezaudio_tpu_torch.codecs.dac import DAC
    from ezaudio_tpu_torch.codecs.discriminator import Discriminator
    from ezaudio_tpu_torch.codecs.encodec import Encodec
    from ezaudio_tpu_torch.codecs.oobleck import AudioVAE
    from ezaudio_tpu_torch.training.codec_trainer import init_codec_

    cls = dict(vae=AudioVAE, dac=DAC, encodec=Encodec, disc=Discriminator)[kind]
    model = init_codec_(cls(**kw), torch.Generator().manual_seed(seed))
    return model.to(dev)


def weight_norm_grads(grads: dict):
    """The largest |gradient| of each ``weight_g`` and ``weight_v``."""
    return {n: g.abs().max().item() for n, g in grads.items()
            if n.endswith(("weight_g", "weight_v"))}


def codec_train_path(dev="cuda", widths=VAE_WIDTHS, batch=CODEC_BATCH, samples=CODEC_SAMPLES,
                     steps=4, sr=24000, disc_kw=None, step_kw=None):
    """Phase 30 (a): the VAE codec trainer at ``widths`` with live weight
    norm, the discriminator at its defaults (``sample_rate=sr``),
    ``make_codec_train_steps`` at its defaults, ``batch`` seeded clips of
    ``samples``, ``steps`` steps.  Every step exactly 24 kernel-2 launches
    (all f32, 2 per ResidualUnit of the model: the encode and the decode);
    every generator and discriminator tensor moved; a non-zero gradient on
    every ``weight_g`` and ``weight_v`` (the last step's)."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.training.codec_trainer import make_codec_train_steps

    cuda = torch.device(dev).type == "cuda"
    vae = build_codec("vae", dev, 0, use_weight_norm=True, **widths)
    disc = build_codec("disc", dev, 1, sample_rate=sr, **(disc_kw or {}))
    step = make_codec_train_steps(vae, disc, "vae", sample_rate=sr, **(step_kw or {}))
    want_res = 2 * sum(isinstance(m, ResidualUnit) for m in vae.encoder.modules())
    audio = torch.from_numpy(codec_clip(sr, samples / sr, batch)).to(dev)
    before = {"gen": snapshot(vae), "disc": snapshot(disc)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shapes = set()
    with resunit_shapes(shapes, full=True):
        rows = timed_steps(dev, steps, lambda i: step(audio, seed=0, return_grads=i == steps - 1))
    peak = mem_gib(torch.cuda.max_memory_allocated) if cuda else None
    last = rows[-1]["out"]
    gv = weight_norm_grads(last.pop("gen_grads"))
    last.pop("disc_grads")
    wall = statistics.median([r["wall_s"] for r in rows[1:]]) if steps > 1 else rows[0]["wall_s"]
    losses = [{k: v.item() for k, v in r["out"].items()} for r in rows]
    # ``unchanged`` names the tensors whose bytes changed
    moved = {side: sorted(set(before[side]) - set(unchanged(m, before[side])))
             for side, m in (("gen", vae), ("disc", disc))}
    row = dict(path="codec_train_vae", card=card_line() if cuda else "cpu", batch=batch,
               samples=samples, sr=sr, steps=steps,
               gen_params=sum(p.numel() for p in vae.parameters()),
               disc_params=sum(p.numel() for p in disc.parameters()),
               step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in rows],
               samples_per_s=batch / wall, audio_s_per_s=batch * samples / sr / wall,
               peak_mem_gib=peak, losses=losses,
               launches_per_step=[r["launches"] for r in rows],
               by_dtype_per_step=[r["by_dtype"] for r in rows],
               weight_norm_tensors=len(gv), weight_norm_min_grad=min(gv.values(), default=0.0),
               unmoved=moved, resunit_batch_shapes=sorted(shapes))
    log("codec_train " + json.dumps(row))
    bad = []
    for i, r in enumerate(rows):
        if r["launches"] != [0, want_res] or r["by_dtype"] != want_by_dtype(0, want_res,
                                                                           "float32"):
            bad.append(f"step {i}: launches {r['launches']} {r['by_dtype']}, want {want_res} f32")
    if not all(np.isfinite(list(d.values())).all() for d in losses):
        bad.append(f"losses {losses}")
    if moved["gen"] or moved["disc"]:
        bad.append(f"tensors that did not move: {moved['gen'][:4]}, {moved['disc'][:4]}")
    if not gv or min(gv.values()) <= 0:
        bad.append(f"zero weight-norm gradients: {[n for n, v in gv.items() if v <= 0][:4]}")
    if bad:
        raise AssertionError("codec train: " + "; ".join(bad))
    row.update(attention_launches=0, resunit_launches=sum(r["launches"][1] for r in rows),
               resunit_shapes=sorted({s[1:3] for s in shapes}, reverse=True))
    return row


def codec_step_agreement(g: dict, c: dict, r: dict, lr: dict, factor: float,
                         kinks=()):
    """A codec step ``g`` against the CPU's ``c`` and the float64 step ``r``
    (each: the metrics, ``gen_grads``, ``disc_grads`` and the updated
    ``gen_params``/``disc_params``), by the limits above with ``factor``;
    a tensor whose name starts with one of ``kinks`` gets the floor
    CODEC_KINK_FLOOR: ``(row, failures)``.  ``lr``: each network's first
    lr.  The row keeps, for each network, the least factor its tensors and
    its L2 distance would pass with (``needed_factor``), and the tensors
    that pass only by the kink floor."""
    bad, worst, dist, largest, needed, kink_only = [], {}, {}, {}, {}, []
    for k, v in c["metrics"].items():
        if not abs(g["metrics"][k] - v) <= CODEC_LOSS_REL * abs(v):
            bad.append(f"{k} {g['metrics'][k]} against {v}")
    for side in ("gen", "disc"):
        gg, cg, rg = g[f"{side}_grads"], c[f"{side}_grads"], r[f"{side}_grads"]
        largest[side] = max(v.abs().max().item() for v in cg.values())
        l2 = {"got": 0.0, "yardstick": 0.0}
        need = 0.0
        for n, w in cg.items():
            got, w, ref = gg[n].double().cpu(), w.double(), rg[n]
            base = max(w.abs().max().item(), CODEC_GRAD_FLOOR * largest[side])
            kink = n.startswith(tuple(kinks))
            scale = max(base, CODEC_KINK_FLOOR * largest[side]) if kink else base
            err = (got - w).abs().max().item()
            off, c_off = (got - ref).abs().max().item(), (w - ref).abs().max().item()
            l2["got"] += (got - ref).square().sum().item()
            l2["yardstick"] += (w - ref).square().sum().item()
            if err / scale > worst.get(side, (0.0, ""))[0]:
                worst[side] = (err / scale, n)
            if err > TRAIN_GRAD_TOL * scale:
                need = max(need, (off - TRAIN_GRAD_TOL * scale) / max(c_off, 1e-300))
            passes = [err <= TRAIN_GRAD_TOL * t or off <= factor * c_off + TRAIN_GRAD_TOL * t
                      for t in (scale, base)]
            if not passes[0]:
                bad.append(f"{side} gradient {n}: {err} from the CPU's, {off} from "
                           f"float64 (the CPU's {c_off}), scale {scale}, the "
                           f"network's largest {largest[side]}")
            elif not passes[1]:
                kink_only.append(n)
        dist[side] = {k: v ** 0.5 for k, v in l2.items()}
        needed[side] = dict(tensors=need,
                            l2=dist[side]["got"] / max(dist[side]["yardstick"], 1e-300))
        if not dist[side]["got"] <= factor * dist[side]["yardstick"]:
            bad.append(f"{side} gradients: {dist[side]['got']} from float64 in L2, the "
                       f"CPU's {dist[side]['yardstick']}")
        for n, p in g[f"{side}_params"].items():
            d = (p.double().cpu() - c[f"{side}_params"][n].double()).abs()
            noise = (gg[n].double().cpu() - rg[n]).abs().maximum((cg[n].double() - rg[n]).abs())
            stable = rg[n].abs() > (4 * noise).clamp_min(1e-4)
            if not (d.max().item() <= 2 * lr[side]
                    and (not stable.any() or d[stable].max().item() <= 1e-3 * lr[side])):
                bad.append(f"{side} parameter {n}: moved {d.max().item()} apart")
    row = dict(metrics={k: [g["metrics"][k], v] for k, v in c["metrics"].items()},
               worst_grad={s: dict(rel_err=w[0], name=w[1]) for s, w in worst.items()},
               l2_from_f64=dist, factor=factor, needed_factor=needed, largest_grad=largest,
               passed_by_the_kink_floor=kink_only,
               n_grads={s: len(c[f"{s}_grads"]) for s in ("gen", "disc")})
    return row, bad


@contextlib.contextmanager
def plain_resunits():
    """The VAE's ResidualUnits on the plain twin (autograd through it) in
    place of kernel 2, on any device."""
    from ezaudio_tpu_torch.codecs import oobleck_fast
    from ezaudio_tpu_torch.ops.kernels.resunit import residual_unit_plain

    orig = oobleck_fast.fused_residual_unit
    oobleck_fast.fused_residual_unit = residual_unit_plain
    try:
        yield
    finally:
        oobleck_fast.fused_residual_unit = orig


@contextlib.contextmanager
def leaky_inputs(disc, record: list):
    """Appends every input of ``disc``'s LeakyReLUs to ``record`` in call
    order, as ``(chain, tensor on the CPU)``: ``chain`` names the list of
    convs that holds the activation (``discriminators.0.convs``,
    ``discriminators.5.band_convs.2``)."""
    import torch

    hooks = [m.register_forward_pre_hook(
        lambda mod, inp, c=name.rsplit(".", 2)[0]: record.append((c, inp[0].detach().cpu())))
        for name, m in disc.named_modules() if isinstance(m, torch.nn.LeakyReLU)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def leaky_flips(got: list, want: list):
    """The LeakyReLU inputs (two :func:`leaky_inputs` records of one step)
    whose sign differs between ``got`` and ``want``, by chain: how many,
    and the largest |input| among them on each side.  ``(rows, prefixes)``:
    the prefixes name the parameters a flip moves, the chain's and its
    sub-discriminator's ``conv_post``."""
    rows = {}
    for (chain, a), (chain_w, b) in zip(got, want, strict=True):
        assert chain == chain_w and a.shape == b.shape, (chain, chain_w)
        flip = (a > 0) != (b > 0)
        if flip.any():
            r = rows.setdefault(chain, dict(n=0, largest_abs_got=0.0, largest_abs_want=0.0))
            r["n"] += int(flip.sum())
            r["largest_abs_got"] = max(r["largest_abs_got"], a[flip].abs().max().item())
            r["largest_abs_want"] = max(r["largest_abs_want"], b[flip].abs().max().item())
    prefixes = sorted({f"{c}." for c in rows}
                      | {".".join(c.split(".")[:2]) + ".conv_post." for c in rows})
    return rows, prefixes


def _codec_step(step, audio, draws):
    out = step(audio, seed=0, draws=draws, return_grads=True)
    return dict(metrics={k: v.item() for k, v in out.items() if "/" in k},
                gen_grads={n: v.detach().cpu() for n, v in out["gen_grads"].items()},
                disc_grads={n: v.detach().cpu() for n, v in out["disc_grads"].items()},
                gen_params=snapshot(step.codec), disc_params=snapshot(step.disc))


def codec_step_card_vs_cpu(dev="cuda", widths=VAE_CUT, batch=2, samples=4800, sr=24000,
                           disc_kw=None, step_kw=None, lr=1e-3):
    """Phase 30 (a), second part: one VAE codec step at cut widths on the
    card as it runs (kernel 2) and with the plain twin in the kernel's
    place, each against the CPU's f32 step with the CPU's float64 step as
    the witness, the same weights and injected posterior noise, by
    :func:`codec_step_agreement` (the limits above); ``lr`` for both
    networks, warmup off (the default warmup's first lr, 1.5e-7, moves
    nothing the limits could read)."""
    import copy

    import torch

    from ezaudio_tpu_torch.training.codec_trainer import make_codec_train_steps

    kw = dict(dict(gen_lr=lr, disc_lr=lr, warmup=0.0), **(step_kw or {}))
    vae = build_codec("vae", "cpu", 2, use_weight_norm=True, **widths)
    disc = build_codec("disc", "cpu", 3, sample_rate=sr, **(disc_kw or {}))
    audio = torch.from_numpy(codec_clip(sr, samples / sr, batch, seed=1))
    frames = samples // vae.downsampling_ratio
    noise = torch.randn(batch, frames, widths["latent_dim"], generator=torch.Generator()
                        .manual_seed(4))
    runs, leaky = {}, {}
    for name, d, dt, ctx in (("card", dev, torch.float32, contextlib.nullcontext),
                             ("card_plain", dev, torch.float32, plain_resunits),
                             ("cpu", "cpu", torch.float32, contextlib.nullcontext),
                             ("f64", "cpu", torch.float64, contextlib.nullcontext)):
        step = make_codec_train_steps(copy.deepcopy(vae).to(d, dt), copy.deepcopy(disc).to(d, dt),
                                      "vae", sample_rate=sr, **kw)
        leaky[name] = []
        reset_counters()
        t0 = time.perf_counter()
        with ctx(), leaky_inputs(step.disc, leaky[name]):
            runs[name] = _codec_step(step, audio.to(d, dt), {"noise": noise.to(d, dt)})
        runs[name]["wall_s"] = time.perf_counter() - t0
        runs[name]["launches"] = list(read_counters())
        del step
    lrs = {"gen": lr, "disc": lr}
    rows, bad = {}, []
    for name, factor in (("card", CODEC_CUDNN_FACTOR * CODEC_KERNEL_FACTOR),
                         ("card_plain", CODEC_CUDNN_FACTOR)):
        flips, kinks = leaky_flips(leaky[name], leaky["cpu"])
        rows[name], b = codec_step_agreement(runs[name], runs["cpu"], runs["f64"], lrs, factor,
                                             kinks)
        rows[name]["leaky_flips"] = flips
        bad += [f"{name}: {x}" for x in b]
    want_res = 6 * len(widths["strides"])  # 3 units a block, encode and decode
    cuda = torch.device(dev).type == "cuda"  # (a CPU rehearsal counts the plain twin)
    if runs["card"]["launches"][1] != want_res or (cuda and runs["card_plain"]["launches"][1]):
        bad.append(f"card launches {runs['card']['launches']} and plain "
                   f"{runs['card_plain']['launches']}, want {want_res} and 0 ResidualUnits")
    row = dict(path="codec_train_vae_card_vs_cpu", widths=widths, batch=batch, samples=samples,
               card_vs_cpu=rows["card"], card_plain_vs_cpu=rows["card_plain"],
               walls_s={k: v["wall_s"] for k, v in runs.items()},
               card_launches=runs["card"]["launches"])
    log("codec_train_card_vs_cpu " + json.dumps(row))
    if bad:
        raise AssertionError("codec step, card against CPU: " + "; ".join(bad[:8]))
    return row


def rvq_scores(model, z, kind: str):
    """The CPU model's score matrix (B*T, codebook size) at each stage of its
    residual quantizer, replayed on the encoder output ``z`` (B, T, D): DAC's
    cosine similarities, EnCodec's minus squared distances over the
    residual's squared norm (higher is better in both)."""
    import torch

    scores = []
    with torch.no_grad():
        if kind == "dac":
            residual = z.transpose(1, 2)
            for q in model.quantizer.quantizers:
                z_q, _, _, _, z_e = q(residual)
                scores.append(q.similarity(z_e))
                residual = residual - z_q
        else:
            residual = z
            for layer in model.quantizer.layers:
                norm = residual.reshape(-1, residual.shape[-1]).square().sum(1, keepdim=True)
                scores.append(-layer.distances(residual) / (norm + 1e-12))
                residual = residual - layer(residual)[0]
    return scores


def near_tie_codes(card, cpu, scores, tie=CODEC_TIE):
    """Card codes against the CPU's (B, N, T) by the near-tie rule:
    ``(row, frames whose codes all agree (B, T) bool, failures)``."""
    import torch

    card, cpu = card.cpu(), cpu.cpu()
    B, N, T = cpu.shape
    differ = card != cpu
    first = torch.where(differ.any(1), differ.float().argmax(1), torch.full((B, T), N))
    gaps, bad = [], []
    for b in range(B):
        for t in range(T):
            i = int(first[b, t])
            if i == N:
                continue
            s = scores[i][b * T + t]
            gap = (s[cpu[b, i, t]] - s[card[b, i, t]]).item()
            gaps.append(gap)
            if not gap <= tie:
                bad.append(f"frame {b},{t} codebook {i}: code {int(card[b, i, t])} against "
                           f"{int(cpu[b, i, t])}, score gap {gap}")
    row = dict(frames=B * T, codebooks=N, frames_differing=len(gaps),
               max_gap=max(gaps, default=0.0), tie=tie)
    return row, first == N, bad


def rel_err(got, want):
    return ((got.float().cpu() - want.float().cpu()).abs().max() /
            want.float().abs().max().clamp_min(1e-12)).item()


def dac_paths(dev="cuda", seconds=10.0, dac_kw=None, train_batch=4, train_samples=22050,
              train_steps=3, disc_kw=None, step_kw=None, tmp=None):
    """Phase 30 (b): DAC at the JAX package's ``DAC()`` defaults (descript's
    44.1 kHz model) on seeded weights: the forward of a seeded ``seconds``
    clip, card against CPU by :func:`near_tie_codes`; ``DACCodec.compress``
    (one window, no normalization) -> a ``.dac`` file -> ``decompress`` on
    the card: codes equal to the forward's and the loudness restored; then
    ``train_steps`` codec steps at ``train_batch`` x ``train_samples``,
    ``quantizer_dropout=0.5``, live weight norm."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.audio.loudness import integrated_loudness
    from ezaudio_tpu_torch.codecs.dacfile import DACCodec, DACFile
    from ezaudio_tpu_torch.training.codec_trainer import make_codec_train_steps

    kw = dac_kw or {}
    cpu_model = build_codec("dac", "cpu", 5, **kw).eval()
    sr = cpu_model.sample_rate
    clip = torch.from_numpy(codec_clip(sr, seconds, seed=2))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(clip)
    cpu_s = time.perf_counter() - t0
    model = build_codec("dac", dev, 5, **kw).eval()
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        got = model(clip.to(dev))
    sync(dev)
    card_s = time.perf_counter() - t0
    with torch.no_grad():
        z_cpu = cpu_model.encode_latent(cpu_model.preprocess(clip))
        ties, agree, bad = near_tie_codes(got["codes"], want["codes"],
                                          rvq_scores(cpu_model, z_cpu, "dac"))
        z_err = rel_err(got["z"].cpu()[agree], want["z"][agree]) if agree.any() else 0.0
        from_cpu_codes = model.decode(model.quantizer.from_codes(
            want["codes"].to(dev))[0])[:, :clip.shape[1]]
        audio_err = rel_err(from_cpu_codes, want["audio"])
    if z_err > CODEC_REL_TOL or audio_err > CODEC_REL_TOL:
        bad.append(f"z {z_err}, audio from the CPU's codes {audio_err} (limit {CODEC_REL_TOL})")

    # the .dac round trip on the card: one window holding the whole clip
    wav = clip[0, :, 0].numpy()
    codec = DACCodec(model)
    win = got["codes"].shape[-1] * model.hop_length / sr  # the forward's padded length
    t0 = time.perf_counter()
    f = codec.compress(wav, sr, win_duration=win, normalize_db=None)
    tmp = tmp or tempfile.mkdtemp(prefix="ezaudio_dac_")
    try:
        path = f.save(os.path.join(tmp, "clip"))
        loaded = DACFile.load(path)
        rec = codec.decompress(loaded)
        file_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    round_trip_s = time.perf_counter() - t0
    in_db, out_db = integrated_loudness(wav, sr), integrated_loudness(rec, sr)
    codes_equal = bool(np.array_equal(loaded.codes, got["codes"].cpu().numpy()))
    if not codes_equal or rec.shape != wav.shape or not abs(out_db - in_db) <= 0.01:
        bad.append(f".dac round trip: codes equal {codes_equal}, {rec.shape}, "
                   f"{out_db} dB against {in_db}")
    row = dict(path="dac", sr=sr, seconds=seconds, params=sum(p.numel() for p in model.parameters()),
               codes_shape=list(got["codes"].shape), near_tie=ties, z_rel_err=z_err,
               audio_from_cpu_codes_rel_err=audio_err, card_forward_s=card_s, cpu_forward_s=cpu_s,
               dacfile=dict(codes_equal=codes_equal, bytes=file_bytes, input_db=in_db,
                            output_db=out_db, round_trip_s=round_trip_s))
    del model, cpu_model, codec
    if bad:
        log("dac " + json.dumps(row))
        raise AssertionError("dac: " + "; ".join(bad[:8]))

    # training steps
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dac = build_codec("dac", dev, 6, quantizer_dropout=0.5, use_weight_norm=True, **kw)
    disc = build_codec("disc", dev, 7, sample_rate=sr, **(disc_kw or {}))
    step = make_codec_train_steps(dac, disc, "dac", sample_rate=sr, **(step_kw or {}))
    audio = torch.from_numpy(codec_clip(sr, train_samples / sr, train_batch, seed=3)).to(dev)
    rows = timed_steps(dev, train_steps, lambda i: step(audio, seed=0))
    losses = [{k: v.item() for k, v in r["out"].items()} for r in rows]
    wall = statistics.median([r["wall_s"] for r in rows[1:]]) if train_steps > 1 else rows[0]["wall_s"]
    row["train"] = dict(batch=train_batch, samples=train_samples, steps=train_steps,
                        step_wall_s=wall, step_wall_s_all=[r["wall_s"] for r in rows],
                        samples_per_s=train_batch / wall,
                        peak_mem_gib=mem_gib(torch.cuda.max_memory_allocated) if cuda else None,
                        losses=losses, launches=[r["launches"] for r in rows])
    log("dac " + json.dumps(row))
    if not all(np.isfinite(list(d.values())).all() for d in losses):
        raise AssertionError(f"dac: train losses {losses}")
    if any(r["launches"] != [0, 0] for r in rows):
        raise AssertionError("dac: its train step launched a kernel")
    return row


def encodec_path(dev="cuda", seconds=10.0, kw=None):
    """Phase 30 (c): EnCodec at the JAX package's ``Encodec()`` defaults
    (24 kHz, dimension 128, n_filters 32, ratios 8/5/4/2, 8 x 1024
    codebooks, LSTM) on seeded weights: encode and decode of a seeded
    ``seconds`` clip, card against CPU by :func:`near_tie_codes`."""
    import torch

    kw = kw or {}
    cpu_model = build_codec("encodec", "cpu", 8, **kw).eval()
    sr = cpu_model.sample_rate
    clip = torch.from_numpy(codec_clip(sr, seconds, seed=4))
    with torch.no_grad():
        t0 = time.perf_counter()
        z_cpu = cpu_model.encoder(clip)
        codes_cpu = cpu_model.quantizer.encode(z_cpu)
        audio_cpu = cpu_model.decode(codes_cpu)
        cpu_s = time.perf_counter() - t0
        model = build_codec("encodec", dev, 8, **kw).eval()
        sync(dev)
        t0 = time.perf_counter()
        z = model.encoder(clip.to(dev))
        codes = model.quantizer.encode(z)
        audio = model.decode(codes)
        sync(dev)
        card_s = time.perf_counter() - t0
        ties, agree, bad = near_tie_codes(codes, codes_cpu, rvq_scores(cpu_model, z_cpu, "encodec"))
        z_err = rel_err(z, z_cpu)
        from_cpu_codes = model.decode(codes_cpu.to(dev))
        audio_err = rel_err(from_cpu_codes, audio_cpu)
    if z_err > CODEC_REL_TOL or audio_err > CODEC_REL_TOL:
        bad.append(f"z {z_err}, audio from the CPU's codes {audio_err} (limit {CODEC_REL_TOL})")
    if audio.shape != clip.shape:
        bad.append(f"audio {tuple(audio.shape)}, want {tuple(clip.shape)}")
    row = dict(path="encodec", sr=sr, seconds=seconds,
               params=sum(p.numel() for p in model.parameters()),
               codes_shape=list(codes.shape), near_tie=ties, z_rel_err=z_err,
               audio_from_cpu_codes_rel_err=audio_err, card_s=card_s, cpu_s=cpu_s,
               codes_equal_share=float((codes.cpu() == codes_cpu).float().mean()))
    log("encodec " + json.dumps(row))
    del model, cpu_model
    if bad:
        raise AssertionError("encodec: " + "; ".join(bad[:8]))
    return row


def facade_paths(dev="cuda", seconds=10.0, vae_kw=None, dac_kw=None, encodec_kw=None,
                 chunk=None):
    """Phase 30 (d): the facade over ``'stable_vae'`` (kernel 2), ``'dac'``
    and ``'encodec'``, each with ``quantization_first`` True and False, on a
    seeded clip: the round trip's shape, the same waveform both ways (the
    bottleneck at encode or at decode, on the same draws), kernel 2's
    launches (12 an encode, 12 a decode, for the VAE only); DAC's chunked
    ``encode_audio`` / ``decode_audio`` (``chunk``: (chunk_size, overlap)
    in frames)."""
    import torch

    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    models = [("stable_vae", build_codec("vae", dev, 9, **(vae_kw or VAE_WIDTHS)), 24000),
              ("dac", build_codec("dac", dev, 10, **(dac_kw or {})), None),
              ("encodec", build_codec("encodec", dev, 11, **(encodec_kw or {})), None)]
    rows, bad = [], []
    for kind, model, sr in models:
        model.eval()
        sr = sr or model.sample_rate
        clip = torch.from_numpy(codec_clip(sr, seconds, seed=5)).to(dev)
        n_res = sum(isinstance(m, ResidualUnit) for m in model.modules())  # enc + dec
        outs = {}
        for q_first in (True, False):
            facade = AutoencoderFacade(model, quantization_first=q_first, model_type=kind)
            gen = torch.Generator(device=dev).manual_seed(12)
            seen = set()
            sync(dev)
            reset_counters()
            with resunit_shapes(seen):
                t0 = time.perf_counter()
                z = facade.encode(clip, generator=gen) if q_first else facade.encode(clip)
                wav = facade.decode(z) if q_first else facade.decode(z, generator=gen)
                sync(dev)
                wall = time.perf_counter() - t0
            launches = list(read_counters())
            outs[q_first] = wav
            r = dict(path=f"facade_{kind}_{'q_first' if q_first else 'q_last'}",
                     latent_shape=list(z.shape), wav_shape=list(wav.shape), wall_s=wall,
                     attention_launches=launches[0], resunit_launches=launches[1],
                     launches_by_dtype=read_dtype_counters(),
                     resunit_shapes=sorted(seen, reverse=True))
            log("facade " + json.dumps(r))
            want_n = n_res if kind == "stable_vae" else 0
            if launches != [0, want_n] or not torch.isfinite(wav).all():
                bad.append(f"{r['path']}: launches {launches} (want {want_n}), finite "
                           f"{bool(torch.isfinite(wav).all())}")
            rows.append(r)
        # the same ops on the same draws, so equal (FUSED_TOL's room for a
        # library routine choosing another algorithm)
        diff = (outs[True] - outs[False]).abs().max().item()
        rows[-1]["q_first_vs_q_last_max_abs"] = diff
        if outs[True].shape != outs[False].shape or not diff <= FUSED_TOL:
            bad.append(f"{kind}: quantization first and last differ by {diff}")
        if kind == "dac":
            size, overlap = chunk or (128, 32)
            facade = AutoencoderFacade(model, model_type="dac")
            sync(dev)
            t0 = time.perf_counter()
            z = facade.encode_audio(clip, chunked=True, chunk_size=size, overlap=overlap)
            wav = facade.decode_audio(z, chunked=True, chunk_size=size, overlap=overlap)
            sync(dev)
            r = dict(path="facade_dac_chunked", chunk=[size, overlap], latent_shape=list(z.shape),
                     wav_shape=list(wav.shape), wall_s=time.perf_counter() - t0,
                     latent_rel_to_unchunked=rel_err(z, facade.encode(clip)),
                     attention_launches=0, resunit_launches=0, resunit_shapes=[])
            log("facade " + json.dumps(r))
            frames = clip.shape[1] // model.hop_length
            if (list(z.shape) != [1, frames, model.latent_dim]
                    or list(wav.shape) != [1, frames * model.hop_length, 1]
                    or not torch.isfinite(wav).all()):
                bad.append(f"chunked DAC: latent {list(z.shape)}, wav {list(wav.shape)}")
            rows.append(r)
    del models, model
    if bad:
        raise AssertionError("facade: " + "; ".join(bad))
    return rows


def delayed_rel_rms(rec, x):
    """The RMS of ``rec`` - ``x`` over ``x``'s, over half the clip, after
    the delay that best aligns them (the PQMF bank's group delay, as
    ``tests/test_pretransforms.py`` measures it)."""
    import numpy as np
    from scipy.signal import correlate

    n = len(x) // 4
    d = int(np.argmax(correlate(rec, x[:n], mode="valid")))
    seg = x[: len(x) // 2]
    r = rec[d: d + len(seg)]
    return float(np.sqrt(np.mean((r - seg) ** 2) / np.mean(seg ** 2)))


def pretransform_paths(dev="cuda", seconds=10.0, sr=24000, bands=16, levels=4):
    """Phase 30 (e): PQMF (``bands``) and the db4 wavelet (``levels``) round
    trips of a seeded clip, card against CPU within CODEC_REL_TOL of the
    CPU output's range; the PQMF's reconstruction error printed."""
    import torch

    from ezaudio_tpu_torch.codecs.pretransforms import PQMFPretransform, WaveletPretransform

    clip = torch.from_numpy(codec_clip(sr, seconds, seed=6))
    rows, bad = [], []
    for name, pre in (("pqmf", PQMFPretransform(num_bands=bands)),
                      ("wavelet_db4", WaveletPretransform(levels=levels))):
        out = {}
        for d in (dev, "cpu"):
            sync(d)
            t0 = time.perf_counter()
            z = pre.encode(clip.to(d))
            y = pre.decode(z)
            sync(d)
            out[str(d)] = (z.cpu(), y.cpu(), time.perf_counter() - t0)
        (zc, yc, tc), (zp, yp, tp) = out[str(dev)], out["cpu"]
        r = dict(path=name, latent_shape=list(zc.shape), z_rel_err=rel_err(zc, zp),
                 y_rel_err=rel_err(yc, yp), card_s=tc, cpu_s=tp,
                 reconstruction_rel_rms=delayed_rel_rms(yc.numpy().ravel(),
                                                        clip.numpy().ravel()))
        log("pretransform " + json.dumps(r))
        if r["z_rel_err"] > CODEC_REL_TOL or r["y_rel_err"] > CODEC_REL_TOL or yc.shape != clip.shape:
            bad.append(f"{name}: {r}")
        rows.append(r)
    if bad:
        raise AssertionError("pretransforms: " + "; ".join(bad))
    return rows


# ---------------------------------------------------------------------------
# Phase 31: the UDiT architecture switches at s3_l width.  Config (a) is
# the reference-torch golden's switch set (tests/fixtures/maskdit_tiny2.npz)
# on s3_l's widths: the 100 T5 tokens, embedded and sinusoidally encoded,
# precede the 500 latent frames, so every block's one attention is a
# self-attention over 600 tokens with a key mask (no cross-attention).
VARIANT_SWITCHES = dict(norm_layer="rmsnorm", qk_norm="rmsnorm", time_fusion="ada_single",
                        ada_sola_rank=None, ada_sola_alpha=None, context_fusion="concat",
                        context_pe_method="sinu", pe_method="abs", rope_mode="x_only",
                        qkv_bias=True, act_layer="gelu", use_conv=False, skip_norm=False)
# (c): a time token before the context (601 tokens), dual RoPE, gated snake
TOKEN_SWITCHES = dict(time_fusion="token", rope_mode="dual", act_layer="gesnake")
# (d): the switch combinations of the CPU tests (tests/test_torch_udit_variants.py),
# each a bare UDiT at s3_l width and depth 2, card against CPU
SWITCH_CASES = {
    "token_concat_abs_sinu": dict(time_fusion="token", rope_mode="none"),
    "rope_x_only": dict(time_fusion="token", context_pe_method="none", pe_method="none",
                        act_layer="geglu", skip=False, use_conv=True),
    "rope_dual": dict(time_fusion="token", context_pe_method="none", pe_method="none",
                      rope_mode="dual"),
    "ada_single_cross": dict(context_fusion="cross", context_pe_method="none"),
    "snake_ff": dict(act_layer="gesnake", time_fusion="token"),
    "2d": dict(input_type="2d", img_size=(16, 100), patch_size=4, in_chans=8, out_chans=8,
               context_fusion="cross", act_layer="geglu", use_conv=True),
    "ada": dict(time_fusion="ada"),
    "cls_ada_sola_bias_joint": dict(time_fusion="ada_sola_bias", ada_sola_rank=32,
                                    ada_sola_alpha=32, context_fusion="joint", cls_dim=64,
                                    rope_mode="shared"),
    "cls_token_dual": dict(time_fusion="token", cls_dim=64, rope_mode="dual"),
    "conv_pe": dict(pe_method="conv", context_pe_method="abs"),
    "gelu_approximate": dict(act_layer="gelu-approximate"),
    "geglu_approximate": dict(act_layer="geglu-approximate", context_fusion="cross"),
    "snake": dict(act_layer="snake"),
}
SWITCH_FRAMES = 100  # latent frames of (d)'s module checks
VARIANT_STEPS = 10  # DDIM steps of (a)-(c) (the reference recipe's 100; cut, see CUT_*)


def variant_config(depth=None, **switches):
    """s3_l's config with config (a)'s switches (and ``switches``) in its
    model block; the context length is the tokenizer's."""
    from ezaudio_tpu_torch.config import get_model_config

    cfg = get_model_config("s3_l").to_dict()
    cfg["model"].update(VARIANT_SWITCHES, context_max_length=cfg["text_encoder"]["max_length"])
    cfg["model"].update(switches)
    if depth is not None:
        cfg["model"]["depth"] = depth
    return cfg


@contextlib.contextmanager
def attention_shapes(seen: set):
    """Add the (Lq, Lk, head_dim, masked) of every kernel-1 call of the
    DiT's blocks to ``seen``."""
    from ezaudio_tpu_torch.models import blocks

    orig = blocks.fused_attention

    def record(q, k, v, key_mask=None, scale=None):
        seen.add((q.shape[2], k.shape[2], q.shape[3], key_mask is not None))
        return orig(q, k, v, key_mask=key_mask, scale=scale)

    blocks.fused_attention = record
    try:
        yield
    finally:
        blocks.fused_attention = orig


def uncovered_attention(seen, cases=ATTN_CASES):
    """The attention shapes of ``seen`` that phase 3 does not hold against
    the plain version (in f32 and bf16)."""
    held = {(Lq, Lk, D, bool(m)) for _, _, Lq, Lk, D, m in cases}
    return sorted(s for s in seen if s not in held)


def variant_run(name, ez, n, reps=1, dtype=None, length=10.0):
    """``generate_audio`` at the reference recipe for ``n`` prompts,
    ``reps`` times, each through :func:`run_path`: one self-attention a
    block per model call (no cross-attention), 12 ResidualUnits a decode."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    depth = ez.params_cfg.model.depth
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    n_samples = int(length * ez.latent_sr) * ez.autoencoder.downsampling_ratio
    return [run_path(f"{name}[{n}]", ez.device,
                     lambda: ez.generate_audio(PROMPTS[:n], length=length, random_seed=1234,
                                               ddim_steps=VARIANT_STEPS)[1],
                     attention_modules(ez.params_cfg.model.to_dict()) * VARIANT_STEPS,
                     want_res, n * length, n_samples, dtype=dtype)
            for _ in range(reps)]


def variant_paths(dev="cuda", before=None, reps=3, length=10.0, attn_cases=ATTN_CASES,
                  replays=2):
    """Phase 31 (a)-(c): config (a) in f32 for 1 prompt (``reps`` times)
    and 4, then ``fused=True`` for 1 (first call and ``replays`` replays,
    equal to staged within FUSED_TOL);
    (b) config (a) in bf16, 1 prompt, every launch bf16; (c) config (a)
    with TOKEN_SWITCHES, 1 prompt.  Kernel 1 launches 25 x VARIANT_STEPS a call,
    kernel 2 12 a decode; every attention shape among phase 3's."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit

    seen, rows = set(), []
    with attention_shapes(seen):
        ez = build_ezaudio(dev, config=variant_config(), model="variant")
        one = variant_run("variant", ez, 1, reps, length=length)
        four = variant_run("variant", ez, 4, length=length)
        want_res = sum(isinstance(m, ResidualUnit)
                       for m in ez.autoencoder.model.decoder.modules())
        fused = fused_run("variant_fused[1]", ez,
                          lambda: ez.generate_audio(PROMPTS[:1], length=length,
                                                    random_seed=1234, fused=True,
                                                    ddim_steps=VARIANT_STEPS)[1],
                          attention_modules(ez.params_cfg.model.to_dict()) * VARIANT_STEPS,
                          want_res, length, replays, one[0]["wav"])
        rows += one + four + [fused]
        summary = dict(card=card_line() if torch.device(dev).type == "cuda" else "cpu",
                       wall_s_1=statistics.median(r["wall_s"] for r in one),
                       wall_s_1_all=[r["wall_s"] for r in one], wall_s_4=four[0]["wall_s"],
                       audio_s_per_s_1=length / statistics.median(r["wall_s"] for r in one),
                       audio_s_per_s_4=four[0]["audio_s_per_s"],
                       fused_replay_s=fused["replay_s"], peak_mem_gib_1=one[0]["peak_mem_gib"],
                       peak_mem_gib_4=four[0]["peak_mem_gib"],
                       dit_params=sum(p.numel() for p in ez.dit.parameters()))
        log("variant_f32 " + json.dumps(summary))
        f32_wav = one[0]["wav"]
        del ez
        if before is not None:
            check_freed("variant f32", before)
        ez = build_ezaudio(dev, config=variant_config(), model="variant", dtype="bfloat16")
        bf16 = variant_run("variant_bf16", ez, 1, dtype="bfloat16", length=length)[0]
        log("variant_bf16_vs_f32 " + json.dumps(dict(
            corr=float(np.corrcoef(bf16["wav"].ravel(), f32_wav.ravel())[0, 1]),
            max_abs_diff=float(np.abs(bf16["wav"] - f32_wav).max()))))
        rows.append(bf16)
        del ez
        if before is not None:
            check_freed("variant bf16", before)
        ez = build_ezaudio(dev, config=variant_config(**TOKEN_SWITCHES), model="variant_token")
        rows += variant_run("variant_token", ez, 1, length=length)
        del ez
        if before is not None:
            check_freed("variant token", before)
    missing = uncovered_attention(seen, attn_cases)
    log("variant_attention_shapes " + json.dumps(sorted(seen)))
    if missing:
        raise AssertionError(f"attention shapes of phase 31 not held in phase 3: {missing}")
    return rows


def _switch_udit(case: dict):
    """A bare UDiT's keyword arguments: config (a)'s model block at depth
    2 with ``case``'s switches, SWITCH_FRAMES latent frames."""
    m = variant_config(depth=2)["model"]
    for k in ("mae", "mae_prob", "mask_ratio", "mask_span"):
        m.pop(k)
    m.update(img_size=SWITCH_FRAMES, use_checkpoint=False)
    m.update(case)
    return m


def _switch_inputs(kw, gen, B=2):
    """Seeded inputs of a UDiT (CPU tensors): x, timesteps, context, its
    mask (23 and 100 valid tokens), the class token."""
    import torch

    if kw.get("input_type") == "2d":
        x = torch.randn(B, *kw["img_size"], kw["in_chans"], generator=gen)
    else:
        x = torch.randn(B, kw["img_size"], kw["in_chans"], generator=gen)
    ctx = torch.randn(B, kw["context_max_length"], kw["context_dim"], generator=gen)
    cmask = torch.ones(B, kw["context_max_length"], dtype=torch.bool)
    cmask[0, 23:] = False
    cls = torch.randn(B, kw["cls_dim"], generator=gen) if kw.get("cls_dim") else None
    return x, torch.tensor([37, 871]), ctx, cmask, cls


def _both(name, model, args, kwargs, dev, want_attn, extra=None):
    """``model`` (on the CPU, seeded) and its copy on ``dev`` on the same
    inputs: :func:`agreement` of the outputs (a tensor or a list, which
    are concatenated) and the card's attention launches."""
    import copy

    import torch

    card = copy.deepcopy(model).to(dev)
    to = lambda a, d: a.to(d) if isinstance(a, torch.Tensor) else a  # noqa: E731
    with torch.no_grad():
        want = model(*args, **kwargs)
        reset_counters()
        got = card(*(to(a, dev) for a in args), **{k: to(v, dev) for k, v in kwargs.items()})
        sync(dev)
        attn = read_counters()[0]
    if isinstance(got, list):
        got, want = torch.cat(got, dim=1), torch.cat(want, dim=1)
    row = agreement(f"variant_card_vs_cpu {name}", got.cpu().numpy(), want.numpy(),
                    dict(extra or {}, attention_launches=attn, want_attention=want_attn))
    if attn != want_attn:
        raise AssertionError(f"{name}: {attn} attention launches, want {want_attn}")
    return row


def variant_card_vs_cpu(gen, dev="cuda"):
    """Phase 31 (d), card against CPU on the same weights and inputs at
    s3_l width, depth 2, phase 5's tolerance: config (a)'s
    ``generate_audio`` (1 s, 3 DDIM steps, eta 0, the same initial
    latents); each SWITCH_CASES UDiT; ``DiTControlNet`` with concat context
    (the energy ControlNet's blocks); ``CFGModel`` and ``ConcatModel`` with
    the same drop decisions; one span-masked train step of config (a)
    (kernel 1's masked self-attention backward)."""
    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.models.cfg_wrappers import CFGModel, ConcatModel
    from ezaudio_tpu_torch.models.controlnet import controlnet_from_config
    from ezaudio_tpu_torch.models.udit import UDiT

    rows = [card_vs_cpu(gen, dev, cfg=variant_config(depth=2))]
    cpu_gen = torch.Generator().manual_seed(31)

    def seeded(model):
        return init_random_(model, cpu_gen).eval()

    for name, case in SWITCH_CASES.items():
        kw = _switch_udit(case)
        x, t, ctx, cmask, cls = _switch_inputs(kw, cpu_gen)
        rows.append(_both(name, seeded(UDiT(**kw)), (x, t, ctx),
                          dict(context_mask=cmask, cls_token=cls), dev,
                          attention_modules(kw), dict(switches=case)))
    kw = _switch_udit({})
    cn = seeded(controlnet_from_config(kw, get_model_config("energy").to_dict()["controlnet"]))
    x, t, ctx, cmask, _ = _switch_inputs(kw, cpu_gen)
    cond = torch.rand(2, SWITCH_FRAMES * 2 ** (len(cn.controlnet_pre.blocks)), 1,
                      generator=cpu_gen)
    rows.append(_both("controlnet_concat", cn, (x, t, ctx),
                      dict(context_mask=cmask, condition=cond, conditioning_scale=0.7), dev,
                      kw["depth"] // 2))
    drop = torch.tensor([True, False])
    kw = _switch_udit(dict(context_fusion="cross", context_pe_method="none"))
    x, t, ctx, cmask, _ = _switch_inputs(kw, cpu_gen)
    rows.append(_both("cfg_model", seeded(CFGModel(kw["context_dim"], UDiT(**kw))), (x, t, ctx),
                      dict(context_mask=cmask, cfg_prob=0.5, drop=drop), dev,
                      attention_modules(kw)))
    kw = _switch_udit(dict(context_dim=None, in_chans=257 + 64))
    cond = torch.randn(2, 4 * SWITCH_FRAMES, 16, generator=cpu_gen)
    rows.append(_both("concat_model",
                      seeded(ConcatModel(UDiT(**kw), 16, strides=(2, 2))),
                      (x, t, cond), dict(cfg_prob=0.5, drop=drop), dev, attention_modules(kw)))
    cfg = variant_config(depth=2)
    rows += train_step_card_vs_cpu(gen, dev, cfg=cfg, policies=("full",),
                                   text_len=cfg["text_encoder"]["max_length"])
    return rows


def codec_restart(dev="cuda", widths=VAE_WIDTHS, batch=CODEC_BATCH, samples=CODEC_SAMPLES,
                  steps=4, sr=24000, disc_kw=None, step_kw=None):
    """Phase 30 (a), ROADMAP F14: the VAE codec step run ``steps`` steps
    straight, against ``steps // 2`` steps, a checkpoint (both networks,
    both optimizers, the step count), a fresh step object on freshly built
    networks restored from it, and the other steps: every loss of those
    steps and every tensor after them bit-equal.  Then the straight run's
    step wall beside the same run with cuDNN's default algorithms (the
    cost of ``deterministic_cudnn``)."""
    import io

    import torch

    from ezaudio_tpu_torch.training import codec_trainer

    audio = torch.from_numpy(codec_clip(sr, samples / sr, batch)).to(dev)

    def fresh(seed=0):
        vae = build_codec("vae", dev, seed, use_weight_norm=True, **widths)
        disc = build_codec("disc", dev, seed + 1, sample_rate=sr, **(disc_kw or {}))
        return codec_trainer.make_codec_train_steps(vae, disc, "vae", sample_rate=sr,
                                                    **(step_kw or {}))

    def run(step, n):
        rows = timed_steps(dev, n, lambda i: step(audio, seed=0))
        return [{k: v.item() for k, v in r["out"].items()} for r in rows], [
            r["wall_s"] for r in rows]

    def state(step):
        return {f"{side}.{k}": v.detach().clone() for side, m in
                (("gen", step.codec), ("disc", step.disc)) for k, v in m.state_dict().items()}

    straight = fresh()
    losses, walls = run(straight, steps)
    want = state(straight)
    del straight
    first = fresh()
    run(first, steps // 2)
    buf = io.BytesIO()
    torch.save({"gen": first.codec.state_dict(), "disc": first.disc.state_dict(),
                "gen_opt": first.gen_opt.state_dict(), "disc_opt": first.disc_opt.state_dict(),
                "step": first.step}, buf)
    del first
    buf.seek(0)
    ckpt = torch.load(buf, map_location=dev, weights_only=False)
    again = fresh(seed=7)  # other weights: the checkpoint must replace them all
    again.codec.load_state_dict(ckpt["gen"])
    again.disc.load_state_dict(ckpt["disc"])
    again.gen_opt.load_state_dict(ckpt["gen_opt"])
    again.disc_opt.load_state_dict(ckpt["disc_opt"])
    again.step = ckpt["step"]
    resumed, _ = run(again, steps - steps // 2)
    got = state(again)
    del again, ckpt
    differ = sorted(k for k in want if not torch.equal(want[k], got[k]))
    orig = codec_trainer.deterministic_cudnn
    codec_trainer.deterministic_cudnn = contextlib.nullcontext
    try:
        default_walls = run(fresh(), steps)[1]
    finally:
        codec_trainer.deterministic_cudnn = orig
    row = dict(path="codec_restart", steps=steps, restart_at=steps // 2,
               losses_straight=losses[steps // 2:], losses_resumed=resumed,
               tensors=len(want), tensors_differ=differ[:8],
               step_wall_s_deterministic=statistics.median(walls[1:]),
               step_wall_s_default=statistics.median(default_walls[1:]),
               walls_deterministic=walls, walls_default=default_walls)
    log("codec_restart " + json.dumps(row))
    if resumed != losses[steps // 2:] or differ:
        raise AssertionError(f"codec restart is not bit-equal: losses {resumed} against "
                             f"{losses[steps // 2:]}, tensors {differ[:8]}")
    return row


# ---------------------------------------------------------------------------
# Phase 32: the demos, AudioSignal, the data path, the quality metrics and
# Whisper.  The card against the CPU:
#   * AudioSignal's stft and mel spectrogram: the f32 FFTs sum in another
#     order, ~1e-6 of the spectrum's largest magnitude; within
#     SIGNAL_SPEC_TOL of it.  MFCC takes the log of the mel + 1e-6, which
#     magnifies the error of the quietest bands: within SIGNAL_MFCC_TOL of
#     the largest coefficient;
#   * the transform batch: each item within DATA_MAX_TOL of its largest
#     magnitude everywhere and within DATA_L2_TOL in relative L2.  The
#     thresholded transforms decide each bin by its dB level: a bin within
#     rounding of the threshold lands on either side, and the spectral
#     gate smooths its mask over 7 x 11 bins, so one flipped bin moves 77
#     bins of the output.  On the CPU, a 1e-7 relative perturbation of every
#     STFT bin moves a 10 s item by up to 4.3e-4 of its scale (8.1e-5 in
#     L2) through SpectralDenoising alone, and cuFFT and pocketfft
#     differ by more in the quiet bins: an H100 reads 1.5e-3 and 5.2e-4
#     (PERF.md section 6).  The limits leave 5-10x that; a fault (a transposed or
#     unscaled spectrum, a lost mask) moves an item by O(1);
#   * Whisper's features and embeddings within WHISPER_REL_TOL of their
#     largest magnitude (f32, TF32 off); the greedy ids equal up to the
#     first position where the CPU's logit of the card's id is within
#     WHISPER_TIE of its top logit (a near tie, as ``near_tie_codes`` is
#     for DAC's codes), compared no further along that row.
SIGNAL_SPEC_TOL = 1e-5
SIGNAL_MFCC_TOL = 1e-4
DATA_MAX_TOL = 1e-2
DATA_L2_TOL = 5e-3
WHISPER_REL_TOL = 1e-4
WHISPER_TIE = 1e-3
# modules the toolkit's paths must not import (the card's machine has none)
TOOLKIT_FORBIDDEN = ("pandas", "matplotlib", "IPython", "transformers")


def vae_units(vae_config=None) -> int:
    """ResidualUnits of one VAE decode: 3 per decoder block."""
    from ezaudio_tpu_torch.config import MODEL_REGISTRY, load_config

    cfg = vae_config or load_config(MODEL_REGISTRY["vae"]["config"]).to_dict()
    return 3 * len(cfg["model"]["decoder"]["config"]["c_mults"])


def demo_paths(root, extra_argv=(), t2a_kw=None, cn_kw=None, clip_s=10.0):
    """Phase 32 (a): ``python -m ezaudio_tpu_torch.demo t2a`` and
    ``... controlnet --ref <a seeded burst clip>`` at their defaults
    (through ``demo.main``; CUDA by default), each building its model from
    scratch; each wall includes the build.  ``extra_argv`` is added to both
    command lines; the launches expected follow the steps they parse to.
    ``t2a_kw``/``cn_kw`` are the configs ``demo.main`` takes (tiny ones in
    the CPU rehearsal)."""
    import torch

    from ezaudio_tpu_torch import demo
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.data.audio_io import load_wav, save_wav

    t2a_kw, cn_kw = t2a_kw or {}, cn_kw or {}
    rows = []
    for name, sub, kw in (("demo_t2a", "t2a", t2a_kw), ("demo_controlnet", "controlnet", cn_kw)):
        out, ref = os.path.join(root, f"{name}.wav"), os.path.join(root, "ref.wav")
        argv = [sub, "--out", out, *extra_argv] + (["--ref", ref] if sub == "controlnet" else [])
        args = demo.parse_args(argv)
        cfg = kw.get("config") or get_model_config(args.model).to_dict()
        sr = cfg["autoencoder"]["sr"]
        seconds = clip_s if sub == "controlnet" else args.length
        if sub == "controlnet":
            save_wav(ref, burst_clip(sr, clip_s), sr)
        dev = args.device or "cuda"
        attn = want_attention(cfg["model"]["depth"], args.steps, controlnet=sub == "controlnet")
        row = run_path(name, dev, lambda: (demo.main(argv, **kw), load_wav(out))[1], attn,
                       vae_units(kw.get("vae_config")), seconds, int(seconds * sr))
        row.update(wav_path=out, sr=sr)
        rows.append(row)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def rel_max(got, want) -> float:
    """max |got - want| / max |want| (numpy)."""
    import numpy as np

    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def signal_checks(path, root, dev="cuda"):
    """Phase 32 (b): ``AudioSignal`` on the t2a demo's wav: load, resample
    to 16 and 44.1 kHz, loudness, normalize to -24 LUFS; ``stft``,
    ``mel_spectrogram`` and ``mfcc`` (their defaults: n_fft 2048, hop 512,
    80 mels, 40 coefficients) on the card against the CPU, each card call
    timed (median of 3); the write/load round trip."""
    import numpy as np

    from ezaudio_tpu_torch.audio.signal import AudioSignal

    sig = AudioSignal.load(path, device=dev)
    cpu = sig.clone().to("cpu")
    row = dict(path="signal", shape=list(sig.audio_data.shape), sr=sig.sample_rate)
    for sr in (16000, 44100):
        r = sig.clone().resample(sr)
        if r.signal_length != round(sig.signal_length * sr / sig.sample_rate):
            raise AssertionError(f"resample to {sr}: {r.signal_length} samples")
    row["loudness"] = sig.loudness()
    row["normalized_loudness"] = sig.clone().normalize(-24.0).loudness()
    if not np.isfinite(row["loudness"]) or abs(row["normalized_loudness"] + 24.0) > 0.1:
        raise AssertionError(f"loudness {row['loudness']}, normalized "
                             f"{row['normalized_loudness']}")
    for method, tol in (("stft", SIGNAL_SPEC_TOL), ("mel_spectrogram", SIGNAL_SPEC_TOL),
                        ("mfcc", SIGNAL_MFCC_TOL)):
        got = getattr(sig, method)()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            getattr(sig, method)()
            walls.append(time.perf_counter() - t0)
        want = getattr(cpu, method)()
        err = rel_max(got, want)
        row[method] = dict(shape=list(got.shape), rel_err=err, tol=tol,
                           card_ms=statistics.median(walls) * 1e3)
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"AudioSignal.{method}: card against CPU {err} (limit {tol})")
    out = os.path.join(root, "round_trip.wav")
    sig.write(out)
    if AudioSignal.load(out) != sig:
        raise AssertionError("AudioSignal write/load round trip differs")
    log("signal " + json.dumps(row))
    return row


def toolkit_compose(sources, ir):
    """A seeded ``Compose`` of every transform class: the ones that round
    or clip first (on the same samples on both sides), then the filters and
    mixes, the spectral ones (``SpectralDenoising`` included), the
    loudness ones, the combinators and ``RescaleAudio`` last."""
    from ezaudio_tpu_torch.data import transforms as T

    return T.Compose([
        T.Quantize(channels=(64, 128), prob=0.5), T.MuLawQuantize(prob=0.5),
        T.ClippingDistortion(prob=0.5), T.Silence(prob=0.1), T.Identity(),
        T.VolumeChange(), T.LowPass(prob=0.5), T.HighPass(prob=0.5), T.Smoothing(prob=0.3),
        T.Equalizer(), T.BackgroundNoise(sources=sources), T.RoomImpulseResponse(sources=[ir]),
        T.CrossTalk(sources=sources, prob=0.5), T.NoiseFloor(), T.InvertPhase(prob=0.5),
        T.FrequencyMask(), T.TimeMask(), T.ShiftPhase(), T.CorruptPhase(prob=0.5),
        T.MaskLowMagnitudes(db_cutoff=(-40.0, -20.0)), T.TimeNoise(), T.FrequencyNoise(),
        T.SpectralDenoising(), T.VolumeNorm(), T.GlobalVolumeNorm(),
        T.Choose([T.ShiftPhase(), T.HighPass()], weights=[1, 2]),
        T.Repeat(T.TimeMask(), n=2), T.RepeatUpTo(T.VolumeChange(db=(-3.0, 0.0)), max_repeat=3),
        T.RescaleAudio(),
    ])


def data_path(root, dev="cuda", clips=16, seconds=10.0, sr=24000, batch=8):
    """Phase 32 (c): ``clips`` seeded ``seconds`` s wavs at ``sr``, a
    ``create_csv`` manifest, an ``AudioDataset`` over it with
    ``toolkit_compose``, batches of ``batch`` on the card (wall per batch)
    and the first batch on the CPU too (the same generator states), each of
    its items held by the DATA_* rule; then ``istft`` of the first batch's
    STFT twice on the card, bit-equal."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.audio.stft import istft, stft
    from ezaudio_tpu_torch.data.audio_dataset import AudioDataset, AudioLoader
    from ezaudio_tpu_torch.data.audio_io import save_wav
    from ezaudio_tpu_torch.data.manifest import create_csv

    audio = os.path.join(root, "audio")
    write_training_set(root, clips=clips, seconds=seconds, sr=sr)
    manifest = os.path.join(audio, "manifest.csv")
    rows = create_csv(audio, manifest)
    ir = np.zeros(int(0.25 * sr), np.float32)
    ir[[0, int(0.02 * sr), int(0.11 * sr)]] = (1.0, 0.5, 0.2)
    ir_path = os.path.join(root, "ir.wav")
    save_wav(ir_path, ir, sr)
    sources = [os.path.join(audio, r["audio_path"]) for r in rows[:2]]

    def dataset(device):
        return AudioDataset(AudioLoader([manifest], transform=toolkit_compose(sources, ir_path)),
                            duration=seconds, sample_rate=sr, n_examples=clips, seed=0,
                            device=device)

    walls, card_batches = [], []
    batches = dataset(dev).batches(batch)
    while True:
        sync(dev)
        t0 = time.perf_counter()
        got = next(batches, None)
        sync(dev)
        if got is None:
            break
        walls.append(time.perf_counter() - t0)
        g = got["signal"].audio_data
        if g.shape != (batch, 1, int(seconds * sr)) or not np.isfinite(g).all():
            raise AssertionError(f"data batch {g.shape}, finite={np.isfinite(g).all()}")
        card_batches.append(g)
    t0 = time.perf_counter()
    w = next(dataset("cpu").batches(batch))["signal"].audio_data
    cpu_s = time.perf_counter() - t0
    g, worst = card_batches[0], dict(max=0.0, l2=0.0)
    for i in range(len(g)):
        scale = max(float(np.abs(w[i]).max()), 1e-12)
        worst["max"] = max(worst["max"], float(np.abs(g[i] - w[i]).max()) / scale)
        worst["l2"] = max(worst["l2"], float(np.linalg.norm(g[i] - w[i])
                                             / max(np.linalg.norm(w[i]), 1e-12)))
    if not (worst["max"] <= DATA_MAX_TOL and worst["l2"] <= DATA_L2_TOL):
        raise AssertionError(f"transform batch card against CPU: {worst} (limits "
                             f"{DATA_MAX_TOL}, {DATA_L2_TOL})")
    x = torch.from_numpy(card_batches[0][:, 0]).to(dev)
    spec = stft(x, 2048, 512)
    a, b = istft(spec, 2048, 512, length=x.shape[-1]), istft(spec, 2048, 512, length=x.shape[-1])
    row = dict(path="data", clips=clips, batch=batch, batches=len(walls),
               wall_per_batch_s=walls, cpu_wall_first_batch_s=cpu_s, rel_err=worst,
               istft_bit_equal=bool(torch.equal(a, b)),
               istft_round_trip=rel_max(a.cpu().numpy(), x.cpu().numpy()))
    log("data " + json.dumps(row))
    if not row["istft_bit_equal"] or not row["istft_round_trip"] <= 1e-5:
        raise AssertionError(f"istft on the card: {row}")
    row["clips"] = card_batches[0][:3, 0]
    return row


def quality_checks(wav, sr):
    """Phase 32 (d): ``stoi``, ``pesq`` and ``visqol_nsim`` of the t2a clip
    against its 4 kHz ``band_limit`` and its 20 dB ``mnru``: finite and in
    range."""
    import numpy as np

    from ezaudio_tpu_torch.audio import effects, quality

    row = dict(path="quality")
    for name, deg in (("band_limit", effects.band_limit(wav, sr, 4000.0)),
                      ("mnru", effects.mnru(wav, 20.0, seed=0))):
        t0 = time.perf_counter()
        nsim = quality.visqol_nsim(deg, wav, sr)
        r = dict(stoi=quality.stoi(deg, wav, sr), pesq=quality.pesq(deg, wav, sr),
                 nsim=nsim["nsim"], mos=nsim["mos"], wall_s=time.perf_counter() - t0)
        row[name] = r
        ok = (np.isfinite(list(r.values())).all() and -1.0 <= r["stoi"] <= 1.0
              and -0.5 <= r["pesq"] <= 4.5 and -1.0 <= r["nsim"] <= 1.0 and 1.0 <= r["mos"] <= 5.0)
        if not ok:
            raise AssertionError(f"quality of {name}: {r}")
    log("quality " + json.dumps(row))
    return row


def whisper_ids_agreement(card_ids, cpu_ids, cpu_logits, prompt_len, tie=WHISPER_TIE):
    """Card ids against the CPU's (B, P + N) by the near-tie rule: ``(row,
    failures)``; ``cpu_logits`` (B, N, vocab) are the CPU's at each new
    token."""
    import numpy as np

    gaps, bad, first = [], [], []
    for b in range(cpu_ids.shape[0]):
        diff = np.flatnonzero(card_ids[b] != cpu_ids[b])
        first.append(int(diff[0]) if diff.size else None)
        if not diff.size:
            continue
        pos = int(diff[0])
        if pos < prompt_len:
            bad.append(f"row {b}: the prompt differs at {pos}")
            continue
        s = cpu_logits[b, pos - prompt_len]
        gap = float(s[int(cpu_ids[b, pos])] - s[int(card_ids[b, pos])])
        gaps.append(gap)
        if not gap <= tie:
            bad.append(f"row {b} position {pos}: id {int(card_ids[b, pos])} against "
                       f"{int(cpu_ids[b, pos])}, logit gap {gap}")
    return dict(rows=int(cpu_ids.shape[0]), first_difference=first,
                max_gap=max(gaps, default=0.0), tie=tie), bad


def whisper_path(wavs, sr, dev="cuda", cfg=None, reps=3, new_tokens=64):
    """Phase 32 (e): ``WhisperTranscriber(sr, device=dev)`` at the JAX
    ``WhisperConfig()`` (whisper-base) on seeded weights (drawn on the CPU,
    loaded on the card): features (1, 80, 3000), embeddings (1, 1500, 512)
    and ``transcribe`` with ``new_tokens`` new tokens at batch 1 and 4,
    walls the median of ``reps``, peak memory; the card against the CPU
    transcriber (WHISPER_* rule)."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.models.whisper import WhisperTranscriber, greedy_decode

    cuda = torch.device(dev).type == "cuda"
    cpu = WhisperTranscriber(sr, cfg=cfg, device="cpu")
    card = WhisperTranscriber(sr, cfg=cfg, weights=cpu.model.state_dict(), device=dev)
    c = card.cfg
    one, four = wavs[:1], wavs[:4]
    row = dict(path="whisper", d_model=c.d_model, layers=[c.encoder_layers, c.decoder_layers],
               vocab=c.vocab_size, new_tokens=new_tokens)

    def timed(name, fn):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(reps):
            sync(dev)
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            walls.append(time.perf_counter() - t0)
        row[name] = dict(wall_s=statistics.median(walls), walls=walls,
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
        return out

    feats = timed("features[1]", lambda: card.features(one))
    emb = timed("embeddings[1]", lambda: card.embeddings(one))
    timed("transcribe[1]", lambda: card.transcribe(one, max_new_tokens=new_tokens))
    ids = timed("transcribe[4]", lambda: card.transcribe(four, max_new_tokens=new_tokens))
    T = 2 * c.max_source_positions
    if tuple(feats.shape) != (1, c.num_mel_bins, T) or tuple(emb.shape) != (
            1, c.max_source_positions, c.d_model) or ids.shape != (len(four), 1 + new_tokens):
        raise AssertionError(f"whisper shapes {tuple(feats.shape)}, {tuple(emb.shape)}, "
                             f"{ids.shape}")
    row["features_rel_err"] = rel_max(feats.cpu().numpy(), cpu.features(one).numpy())
    row["embeddings_rel_err"] = rel_max(emb.cpu().numpy(), cpu.embeddings(one).numpy())
    prompt = (c.decoder_start_token_id,)
    cpu_ids, cpu_logits = greedy_decode(cpu.model, cpu.features(four), prompt,
                                        max_new_tokens=new_tokens, return_logits=True)
    row["ids"], bad = whisper_ids_agreement(ids, cpu_ids, cpu_logits.numpy(), len(prompt))
    row["distinct_ids"] = int(len(np.unique(ids)))
    log("whisper " + json.dumps(row))
    if not (row["features_rel_err"] <= WHISPER_REL_TOL
            and row["embeddings_rel_err"] <= WHISPER_REL_TOL):
        raise AssertionError(f"whisper card against CPU: features {row['features_rel_err']}, "
                             f"embeddings {row['embeddings_rel_err']} "
                             f"(limit {WHISPER_REL_TOL})")
    if bad:
        raise AssertionError(f"whisper ids, card against CPU: {bad}")
    return row


def toolkit_paths(root, dev="cuda", demo_argv=(), t2a_kw=None, cn_kw=None, clip_s=10.0,
                  data_kw=None, whisper_cfg=None):
    """Phase 32: (a) the demos, (b) AudioSignal on the t2a clip, (c) the
    data path, (d) the quality metrics, (e) Whisper on the t2a clip (batch
    1) and on it and the data batch's first three items (batch 4).  Returns the demos' path rows.  None
    of it may import a module of TOOLKIT_FORBIDDEN."""
    import numpy as np

    before = set(sys.modules)
    demos = demo_paths(root, demo_argv, t2a_kw, cn_kw, clip_s)
    t0 = time.perf_counter()
    signal_checks(demos[0]["wav_path"], root, dev)
    log(f"phase 32 (b) signal: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    data = data_path(root, dev, **(data_kw or {}))
    log(f"phase 32 (c) data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wav, sr = demos[0]["wav"], demos[0]["sr"]
    quality_checks(wav, sr)
    log(f"phase 32 (d) quality: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_path(np.concatenate([wav[None], data["clips"][:, :wav.shape[-1]]]), sr, dev,
                 cfg=whisper_cfg)
    log(f"phase 32 (e) whisper: {time.perf_counter() - t0:.1f} s")
    new = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in TOOLKIT_FORBIDDEN)
    if new:
        raise AssertionError(f"phase 32 imported {new[:5]}")
    return demos


# ---------------------------------------------------------------------------
# Phase 33: non-wav audio through the codec bridge and the native batch
# loader (a), the parallel paths at a world of one on NCCL (b), and the
# sequence-parallel ring's per-hop math at sp = 4 in one process (c).
# mp3 at 320 kbps and vorbis at its default quality are lossy: the decoded
# 10 s clip is held by its SNR against the input (white noise, the hardest
# input, reads 10.7 dB and 5.8 dB through them on the CPU; a misaligned or
# garbled decode reads 0 dB or less).  flac of a clip on the 16-bit grid
# (peak 0.45, where the bridge's 32767-in, 32768-out scaling is the
# identity) is lossless: bit-exact.
MP3_BITRATE = 320000
MP3_MIN_SNR_DB = 6.0
OGG_MIN_SNR_DB = 3.0
# the parallel path at a world of one against the plain one on the card:
# the same kernels on the same inputs in the same order
MESH_TOL = 1e-5
CUT_MESH_STEPS = 5       # DDIM steps of (b)'s generate calls (the recipe's 100)
CUT_MESH_TRAIN_DEPTH = 4  # (b)'s train steps: s3_l's widths at this depth (24)
RING_SP = 4
RING_CASES = [(2, 16, 500, 500, 64), (2, 16, 500, 500, 72)]   # s3_l, s3_xl self


def snr_db(got, want) -> float:
    import numpy as np

    n = min(len(got), len(want))
    err = float(((got[:n] - want[:n]) ** 2).sum())
    return float(10 * np.log10(float((want[:n] ** 2).sum()) / max(err, 1e-30)))


def nonwav_paths(clip, sr, root, dev="cuda", clips=16, seconds=10.0, batch=8, vae_config=None,
                 excerpt_s=2.0):
    """Phase 33 (a): build the codec bridge and the native loader into the
    build directory; ``clip`` (phase 4's t2a waveform) through flac (on
    the 16-bit grid: bit-exact), mp3 and ogg (SNR) with ``save_audio`` and
    ``load_audio``, and ``AudioSignal.load`` of the mp3; then
    ``EACaps(use_native=True)`` over ``clips`` seeded ``seconds`` s wavs in
    batches of ``batch``: one ``load_batch`` call a batch (wall), the VAE
    encode (the posterior mean) of each batch on the card with its kernel 2
    launches counted; the first item's first ``excerpt_s`` seconds encoded
    on the card and on the CPU (plain versions), held by PIPE_REL_TOL.
    Without libav it says so and runs the native loader alone; without
    ``g++`` it fails."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.audio.signal import AudioSignal
    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit, vae_from_config
    from ezaudio_tpu_torch.config import MODEL_REGISTRY, load_config
    from ezaudio_tpu_torch.data import codec_loader, native_build, native_loader
    from ezaudio_tpu_torch.data.audio_io import load_audio, save_audio
    from ezaudio_tpu_torch.data.dataset import EACaps

    gxx = native_build.gxx()
    log(f"non-wav: g++ {'found at ' + gxx if gxx else 'missing'}")
    if gxx is None:
        raise AssertionError("g++ is missing: the native loader cannot be built")
    t0 = time.perf_counter()
    if not native_loader.available():
        raise AssertionError(f"the native loader did not build: {native_loader.build_error}")
    libav = codec_loader.available()
    row = dict(path="nonwav", build_s=time.perf_counter() - t0, libav=libav,
               native_lib=native_loader.lib_path(), attention_launches=0)
    if libav:
        log(f"non-wav: libav found; the codec bridge built into {codec_loader.lib_path()}")
        # on the 16-bit grid q / 32768 with |q| < 2^14: the bridge writes
        # lrint(32767 v) and reads q / 32768, the identity on that range
        x = np.asarray(clip, np.float32).reshape(-1)
        x = np.round(x / max(float(np.abs(x).max()), 1e-9) * 0.45 * 32768) / 32768.0
        x = x.astype(np.float32)
        formats = {}
        for ext, kw in (("flac", {}), ("mp3", dict(bitrate=MP3_BITRATE)), ("ogg", {})):
            path = os.path.join(root, f"t2a.{ext}")
            t1 = time.perf_counter()
            save_audio(path, x, sr, **kw)
            enc_s = time.perf_counter() - t1
            decode_ms = []
            for _ in range(5):
                t1 = time.perf_counter()
                y, rate = load_audio(path)
                decode_ms.append((time.perf_counter() - t1) * 1e3)
            formats[ext] = dict(bytes=os.path.getsize(path), encode_s=enc_s,
                                decode_ms=statistics.median(decode_ms), sr=rate,
                                samples=[len(y), len(x)], snr_db=snr_db(y, x),
                                bit_exact=bool(len(y) == len(x) and np.array_equal(y, x)))
        sig = AudioSignal.load(os.path.join(root, "t2a.mp3"), device=dev)
        row.update(formats=formats, signal=dict(shape=list(sig.audio_data.shape),
                                                sr=sig.sample_rate))
        bad = [f"{e}: {f}" for e, f in formats.items() if f["sr"] != sr]
        if not formats["flac"]["bit_exact"]:
            bad.append(f"flac not bit-exact: {formats['flac']}")
        if not formats["mp3"]["snr_db"] >= MP3_MIN_SNR_DB:
            bad.append(f"mp3 SNR {formats['mp3']['snr_db']:.2f} dB < {MP3_MIN_SNR_DB}")
        if not formats["ogg"]["snr_db"] >= OGG_MIN_SNR_DB:
            bad.append(f"ogg SNR {formats['ogg']['snr_db']:.2f} dB < {OGG_MIN_SNR_DB}")
        if sig.sample_rate != sr or sig.audio_data.shape[-1] != formats["mp3"]["samples"][0]:
            bad.append(f"AudioSignal.load of the mp3: {row['signal']}")
        if bad:
            raise AssertionError("non-wav: " + "; ".join(bad))
    else:
        log(f"non-wav: libav not found on this machine ({codec_loader.build_error}); "
            "mp3/flac/ogg skipped, the native wav loader runs alone")

    meta = write_training_set(root, clips=clips, seconds=seconds, sr=sr)
    ds = EACaps(data_dir=os.path.join(root, "audio"), meta_dir=meta, seg_length=seconds, sr=sr,
                use_native=True, seed=0)
    if not ds.use_native:
        raise AssertionError("EACaps(use_native=True) did not take the native loader")
    vae_cfg = vae_config or load_config(MODEL_REGISTRY["vae"]["config"]).to_dict()
    with torch.device(dev):
        vae = vae_from_config(vae_cfg)
    init_random_(vae, torch.Generator(device=dev).manual_seed(33)).eval()
    card = AutoencoderFacade(vae)
    want_res = sum(isinstance(m, ResidualUnit) for m in vae.encoder.modules())
    walls, launches, seen, first = [], [], set(), None  # first: the excerpt
    batches = ds.batches(batch)
    with torch.no_grad(), resunit_shapes(seen, full=True):
        while True:
            t1 = time.perf_counter()
            b = next(batches, None)
            if b is None:
                break
            walls.append(time.perf_counter() - t1)
            audio = b["audio"]
            if audio.shape != (batch, int(seconds * sr)) or not np.isfinite(audio).all():
                raise AssertionError(f"native batch {audio.shape}")
            reset_counters()
            lat = card.encode(torch.from_numpy(audio).to(dev)[:, :, None], sample=False)
            sync(dev)
            launches.append(read_counters()[1])
            if first is None:
                first = audio[:1, :int(excerpt_s * sr)].copy()
    cpu_vae = vae_from_config(vae_cfg)
    cpu_vae.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    with torch.no_grad():
        x = torch.from_numpy(first)[:, :, None]
        got = card.encode(x.to(dev), sample=False).float().cpu().numpy()
        want = AutoencoderFacade(cpu_vae.eval()).encode(x, sample=False).numpy()
    err = rel_max(got, want)
    row.update(batches=len(walls), load_batch_s=walls, resunit_launches=sum(launches),
               launches_per_batch=launches, encode_rel_err=err,
               resunit_batch_shapes=sorted(seen), resunit_shapes=[])
    log("nonwav " + json.dumps(row))
    if launches != [want_res] * (clips // batch):
        raise AssertionError(f"native batches' encode launches {launches}, want {want_res} each")
    if not err <= PIPE_REL_TOL:
        raise AssertionError(f"native batch encode, card against CPU: {err} > {PIPE_REL_TOL}")
    return row


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world_one_paths(dev="cuda", cfg=None, t5_config=None, vae_config=None, length=10.0,
                    steps=CUT_MESH_STEPS, batch=2, init_method=None,
                    train_depth=CUT_MESH_TRAIN_DEPTH):
    """Phase 33 (b): a world of one (NCCL on the card): ``EzAudio(mesh=
    make_mesh())`` at 1 prompt and ``steps`` DDIM steps against the
    mesh-less EzAudio at the same seed (launches counted; then both again,
    warm, four times each in the order mesh, plain, plain, mesh, twice, for
    the walls and their spread); one train step (the
    model at ``train_depth``) of a plain ``Trainer``, of
    ``Trainer.create(mesh=make_mesh())`` and of one whose DiT FSDP2 wraps
    (HSDP over the (dp, fsdp) = (1, 1) sub-mesh, each parameter's fsdp
    axis taken as a 2-way split would) on the same weights, batch and
    draws, each held to the plain step by phase 25's limits, then two warm
    steps of each timed (the plain trainer's again last); then
    :func:`bf16_hsdp_step`.  Leaves the process group."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from ezaudio_tpu_torch.api.ezaudio import EzAudio, init_random_
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.parallel import init_distributed, make_mesh, param_shardings
    from ezaudio_tpu_torch.parallel.mesh import AXES

    class FsdpTwo:
        """The one size the fsdp rule reads, 2: the placements of a 2-way
        split, which FSDP2 applies over the world of one."""

        def size(self, i=None):
            return 2 if i == AXES.index("fsdp") else 1
    from ezaudio_tpu_torch.training.trainer import Trainer

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("s3_l").to_dict())
    t0 = t_phase = time.perf_counter()
    rank_dev = init_distributed(dev, init_method=init_method
                                or f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    mesh = make_mesh()
    log(f"world: {dist.get_backend()} group of {dist.get_world_size()} on {rank_dev}, mesh "
        f"{tuple(mesh.mesh.shape)} in {time.perf_counter() - t0:.2f} s")
    rows = []
    try:
        kw = dict(config=cfg, t5_config=t5_config, vae_config=vae_config, device=rank_dev,
                  seed=0)
        solo = EzAudio(**kw)
        t0 = time.perf_counter()
        ez = EzAudio(mesh=mesh, **kw)
        build_s = time.perf_counter() - t0
        depth = cfg["model"]["depth"]
        want_res = sum(isinstance(m, ResidualUnit)
                       for m in solo.autoencoder.model.decoder.modules())
        n_samples = int(length * solo.latent_sr) * solo.autoencoder.downsampling_ratio
        gen = dict(length=length, ddim_steps=steps, random_seed=1234)
        want_attn = 2 * (depth + 1) * steps
        plain = run_path("mesh_off[1]", rank_dev,
                         lambda: solo.generate_audio(PROMPTS[:1], **gen)[1],
                         want_attn, want_res, length, n_samples)
        meshed = run_path("mesh_world1[1]", rank_dev,
                          lambda: ez.generate_audio(PROMPTS[:1], **gen)[1],
                          want_attn, want_res, length, n_samples)
        err = rel_max(meshed["wav"], plain["wav"])
        # the walls again, warm, alternating: mesh, plain, plain, mesh, twice
        walls = {"mesh": [], "plain": []}
        for name in ("mesh", "plain", "plain", "mesh") * 2:
            sync(rank_dev)
            t1 = time.perf_counter()
            (ez if name == "mesh" else solo).generate_audio(PROMPTS[:1], **gen)
            sync(rank_dev)
            walls[name].append(time.perf_counter() - t1)
        overhead = statistics.mean(walls["mesh"]) - statistics.mean(walls["plain"])
        # the spread: the largest gap between two walls of one kind
        spread = max(max(v) - min(v) for v in walls.values())
        meshed.update(mesh_build_s=build_s, rel_err_vs_no_mesh=err, warm_walls_s=walls,
                      overhead_s=overhead, spread_s=spread)
        log(f"mesh_world1 rel_err {err:.3e}, warm walls {walls} s, overhead "
            f"{overhead * 1e3:.1f} ms, spread within a kind {spread * 1e3:.1f} ms")
        if not err <= MESH_TOL:
            raise AssertionError(f"EzAudio(mesh) at a world of one: {err} > {MESH_TOL}")
        rows += [plain, meshed]
        del solo, ez

        m = dict(cfg["model"], depth=min(train_depth, cfg["model"]["depth"]))
        schedule = DDIMSchedule.from_config(cfg["diff"])
        lr = 1e-4
        opt = dict(learning_rate=lr, warmup=0, grad_clip=1.0, weight_decay=0.01, snr_gamma=5.0)
        with torch.device(rank_dev):
            first = maskdit_from_config(m)
        init_random_(first, torch.Generator(device=rank_dev).manual_seed(33))
        weights = {k: v.cpu() for k, v in first.state_dict().items()}
        del first
        host_gen = torch.Generator().manual_seed(33)
        frames, C, ctx, text_len = m["img_size"], m["out_chans"], m["context_dim"], 100
        text_mask = torch.ones(batch, text_len, dtype=torch.bool)
        text_mask[0, 23:] = False
        host = dict(latents=torch.randn(batch, frames, C, generator=host_gen),
                    text=torch.randn(batch, text_len, ctx, generator=host_gen),
                    text_mask=text_mask,
                    uncond=torch.randn(1, text_len, ctx, generator=host_gen),
                    uncond_mask=torch.arange(text_len)[None] < 1)

        def step(kind, dtype=None):
            with torch.device(rank_dev):
                model = maskdit_from_config(m)
            model.load_state_dict(weights)
            model.train()
            extra = {}
            if kind != "plain":
                extra["mesh"] = mesh
            if kind == "hsdp":
                extra["placements"] = param_shardings(FsdpTwo(), model)
            trainer = Trainer.create(model, schedule, opt, dtype=dtype, **extra)
            sh = trainer.sharding
            full = (lambda n, t: sh.to_full(n, t)) if sh is not None else (lambda n, t: t)
            draws = trainer.step_fn.draw(torch.Generator().manual_seed(34), batch, frames, C,
                                         "cpu")
            draws["cfg"][:] = torch.tensor([0.05] + [0.9] * (batch - 1))
            data = {k: v.to(rank_dev, dtype if dtype and v.is_floating_point() else v.dtype)
                    for k, v in host.items()}
            sync(rank_dev)
            reset_counters()
            res = trainer.step_fn(data, seed=0,
                                  draws={k: v.to(rank_dev) for k, v in draws.items()},
                                  return_grads=True)
            sync(rank_dev)
            launches, by_dtype = read_counters(), read_dtype_counters()
            faults = mixed_precision_faults(trainer) if dtype == torch.bfloat16 else []
            grads = {k: full(k, v).detach().cpu() for k, v in res["grads"].items()}
            params = {k: full(k, v).detach().cpu() for k, v in model.named_parameters()}
            walls = []
            for i in range(2):  # warm steps, timed (their own draws)
                sync(rank_dev)
                t1 = time.perf_counter()
                trainer.step_fn(data, seed=1 + i)
                sync(rank_dev)
                walls.append(time.perf_counter() - t1)
            out = dict(loss=res["loss"].item(), grad_norm=res["grad_norm"].item(),
                       grads=grads, params=params, launches=launches, by_dtype=by_dtype,
                       faults=faults, wall_s=statistics.median(walls),
                       wrapped=bool(sh is not None and sh.wrapped),
                       dtensors=sum(hasattr(p, "device_mesh") for p in model.parameters()))
            del trainer, model, res, sh
            if kind == "hsdp":
                # FSDP2's hooks hold the module and its state in a reference
                # cycle: a wrapped model is freed by the collector alone
                # (ROADMAP F20)
                import gc

                gc.collect()
            return out

        log(f"world: generate checks done at {time.perf_counter() - t_phase:.1f} s")
        plain_step = step("plain")
        plain_walls = [plain_step["wall_s"]]
        for kind in ("mesh", "hsdp", "plain"):
            if kind == "plain":  # timed again, after the allocator has grown
                plain_walls.append(step("plain")["wall_s"])
                break
            got = step(kind)
            row, failed = train_step_agreement(got, plain_step, lr, m["depth"],
                                               train_attention_launches(m),
                                               n_attn=attention_modules(m))
            row.update(path=f"train_world1_{kind}", wall_s=got["wall_s"],
                       plain_wall_s=plain_walls, fsdp2_wrapped=got["wrapped"],
                       dtensor_params=got["dtensors"], batch=batch, depth=m["depth"])
            log("train_world1 " + json.dumps(row))
            log(f"world: {kind} step checked at {time.perf_counter() - t_phase:.1f} s")
            if kind == "hsdp" and not (got["wrapped"] and got["dtensors"] > 0):
                raise AssertionError("the HSDP trainer did not wrap its DiT in FSDP2")
            if failed:
                raise AssertionError(f"train step at a world of one ({kind}) against the "
                                     "plain step: " + "; ".join(failed))
            rows.append(row)
        log(f"train_world1 plain step walls {plain_walls} s (first, last)")
        rows.append(bf16_hsdp_step(step, plain_step, weights, m))
        log(f"world: bf16 steps checked at {time.perf_counter() - t_phase:.1f} s")
    finally:
        dist.destroy_process_group()
        log(f"world: left the group at {time.perf_counter() - t_phase:.1f} s")
    return rows


def bf16_hsdp_step(step, f32_step: dict, weights: dict, m: dict) -> dict:
    """Phase 33 (b)'s bf16 steps: ``step(kind, dtype)`` of
    ``world_one_paths`` for the plain and the HSDP-wrapped trainer in bf16
    (FSDP2 gathering in bf16, ``parallel/sharding.py``), the wrapped one
    held to the plain one by phase 28's rule with the f32 plain step
    ``f32_step`` as its reference: the gradients and the updates (one
    vector each) no farther from the plain bf16 ones than
    ``BF16_REF_FACTOR`` times the plain bf16 step's distance from the f32
    step, correlated above ``BF16_TRAIN_CORR``, the loss within
    ``BF16_LOSS_REL``, every kernel 1 launch bf16, no
    ``mixed_precision_faults``.  The row (a path: kernel 1's launches)."""
    import torch

    plain, hsdp = step("plain", torch.bfloat16), step("hsdp", torch.bfloat16)
    names = sorted(f32_step["grads"])

    def flat(run, key):
        if key == "grads":
            return torch.cat([run["grads"][n].float().ravel() for n in names])
        return torch.cat([(run["params"][n] - weights[n]).float().ravel() for n in names])

    d_grad, d_ref, corr = bf16_agreement_stats(flat(hsdp, "grads"), flat(plain, "grads"),
                                               flat(f32_step, "grads"))
    d_upd, d_upd_ref, upd_corr = bf16_agreement_stats(
        flat(hsdp, "update"), flat(plain, "update"), flat(f32_step, "update"))
    want = train_attention_launches(m)
    row = dict(path="train_world1_hsdp_bf16", depth=m["depth"],
               loss=[hsdp["loss"], plain["loss"], f32_step["loss"]], grad_to_plain=d_grad,
               grad_plain_bf16_to_f32=d_ref, grad_corr=corr, update_to_plain=d_upd,
               update_plain_bf16_to_f32=d_upd_ref, update_corr=upd_corr,
               wall_s=hsdp["wall_s"], plain_wall_s=plain["wall_s"],
               fsdp2_wrapped=hsdp["wrapped"], dtensor_params=hsdp["dtensors"],
               faults=hsdp["faults"] + plain["faults"], by_dtype=hsdp["by_dtype"],
               attention_launches=hsdp["launches"][0], resunit_launches=hsdp["launches"][1],
               resunit_shapes=[])
    log("train_world1 " + json.dumps(row))
    bad = []
    if not (hsdp["wrapped"] and hsdp["dtensors"] > 0):
        bad.append("the bf16 HSDP trainer did not wrap its DiT in FSDP2")
    if not (d_grad <= BF16_REF_FACTOR * d_ref and corr > BF16_TRAIN_CORR):
        bad.append(f"gradients {d_grad} vs {d_ref}, corr {corr}")
    if not (d_upd <= BF16_REF_FACTOR * d_upd_ref and upd_corr > BF16_TRAIN_CORR):
        bad.append(f"updates {d_upd} vs {d_upd_ref}, corr {upd_corr}")
    if not abs(hsdp["loss"] - plain["loss"]) <= BF16_LOSS_REL * abs(plain["loss"]):
        bad.append(f"loss {hsdp['loss']} vs {plain['loss']}")
    if row["faults"]:
        bad.append(f"mixed precision {row['faults'][:4]}")
    for run in (hsdp, plain):
        if run["launches"][0] != want or run["by_dtype"] != want_by_dtype(want, 0, "bfloat16"):
            bad.append(f"launches {run['by_dtype']}, want {want} bf16")
    if bad:
        raise AssertionError("bf16 HSDP step at a world of one against the plain bf16 step: "
                             + "; ".join(bad))
    return row


def controlnet_nocontext_path(dev="cuda", cfg=None, depth=CUT_MESH_TRAIN_DEPTH, batch=2):
    """Phase 33 (b), last: one ``DiTControlNet`` forward over a base without
    text (the energy config's widths with ``context_dim`` None, at
    ``depth``: depth // 2 blocks, self-attention only) on the card (kernel
    1, its launches counted) against the CPU (the plain twin) on the same
    seeded weights and inputs, by phase 14's rule (``agreement``); at
    scale 0 every skip is 0 and at scale 1 none is (ROADMAP F6).  The row
    (a path)."""
    import copy

    import numpy as np
    import torch

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.models.controlnet import controlnet_from_config

    cfg = copy.deepcopy(cfg if cfg is not None else get_model_config("energy").to_dict())
    m = dict(cfg["model"], context_dim=None, depth=depth)
    with torch.device(dev):
        card = controlnet_from_config(m, cfg["controlnet"])
    init_random_(card, torch.Generator(device=dev).manual_seed(36)).eval()
    cpu = controlnet_from_config(m, cfg["controlnet"]).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    gen = torch.Generator().manual_seed(37)
    L = m["img_size"]
    x = torch.randn(batch, L, m["in_chans"], generator=gen)
    frames = L * 2 ** (len(cfg["controlnet"]["cond_blocks"]) - 1)
    cond = torch.rand(batch, frames, cfg["controlnet"]["cond_in"], generator=gen)
    t = torch.randint(0, 1000, (batch,), generator=gen)

    def skips(model, device, scale):
        with torch.no_grad():
            out = model(x.to(device), t.to(device), condition=cond.to(device),
                        conditioning_scale=scale)
        return np.stack([s.float().cpu().numpy() for s in out])

    sync(dev)
    reset_counters()
    t1 = time.perf_counter()
    got = skips(card, dev, 1.0)
    sync(dev)
    wall = time.perf_counter() - t1
    attn, res = read_counters()
    zero = skips(card, dev, 0.0)
    row = agreement("controlnet_nocontext", got, skips(cpu, "cpu", 1.0),
                    dict(path="controlnet_nocontext", depth=depth, batch=batch, wall_s=wall,
                         attention_launches=attn, resunit_launches=res, resunit_shapes=[]))
    if (attn, res) != (depth // 2, 0):
        raise AssertionError(f"controlnet_nocontext launches {attn}, {res}, want {depth // 2}, 0")
    if zero.any() or not all(np.abs(s).max() > 0 for s in got):
        raise AssertionError("controlnet_nocontext: scale 0 must add nothing, scale 1 something")
    return row


def ring_math(dev="cuda", gen=None, cases=RING_CASES, sp=RING_SP, time_it=True):
    """Phase 33 (c): the ring's per-hop functions at sp = ``sp`` in one
    process over hand-rotated blocks (``ring_blocks_forward`` /
    ``_backward``), f32 and bf16, with and without a T5-style key mask.
    f32: the output held to kernel 1's (ATTN_F32_ATOL), the gradients to
    SDPA's (SDPA_GRAD_TOL).  bf16: the output within one bf16 ulp (plus
    one) of the f32 attention of the same bf16 inputs, and within
    2^-8 max|v| plus two ulps of kernel 1's bf16 output (its p is rounded
    to bf16); the gradients by phase 28's rule against SDPA's bf16 ones.
    The ring's forward and backward timed beside kernel 1's forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ezaudio_tpu_torch.ops.kernels.attention import attention_plain, fused_attention
    from ezaudio_tpu_torch.parallel.ring_attention import (ring_blocks_backward,
                                                           ring_blocks_forward)

    rows = []
    for (B, H, Lq, Lk, D) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for masked in (False, True):
                dname = str(dtype).split(".")[-1]
                q, k, v = (torch.randn(B, H, L, D, device=dev, generator=gen).to(dtype)
                           for L in (Lq, Lk, Lk))
                dout = torch.randn(B, H, Lq, D, device=dev, generator=gen)
                mask = key_mask(B, Lk, masked, dev)
                sdpa_mask = None if mask is None else mask[:, None, None, :]
                out, _, _ = ring_blocks_forward(q, k, v, mask, sp=sp)
                kern = fused_attention(q, k, v, key_mask=mask)
                got = dict(zip("qkv", ring_blocks_backward(q, k, v, dout.to(dtype), mask,
                                                           sp=sp)))

                def sdpa_grads(dt):
                    ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
                    o = F.scaled_dot_product_attention(*ins, attn_mask=sdpa_mask)
                    return dict(zip("qkv", torch.autograd.grad(o, ins, dout.to(dt))))

                sdpa = sdpa_grads(dtype)
                sync(dev)
                row = dict(shape=[B, H, Lq, Lk, D], dtype=dname, masked=masked, sp=sp)
                if dtype == torch.float32:
                    ok_fwd, err, share = attention_agreement(out, kern, v)
                    ok_bwd, by = grad_agreement(got, sdpa, SDPA_GRAD_TOL)
                    row.update(max_abs_err_vs_kernel=err, grads_rel_err_vs_sdpa={
                        n: r["rel_err"] for n, r in by.items()})
                else:
                    ref = attention_plain(q.float(), k.float(), v.float(), key_mask=mask)
                    ok_ref, err_ref, share = bf16_agreement(out, ref)
                    slack = 2.0 ** -8 * v.float().abs().max() + 2.0 ** -6 * ref.abs() + 2e-5
                    d_kern = (out.float() - kern.float()).abs()
                    ok_fwd = ok_ref and bool((d_kern <= slack).all())
                    f32 = {n: g.float() for n, g in sdpa_grads(torch.float32).items()}
                    stats, ok_bwd = {}, True
                    for n in "qkv":
                        d_ring = (got[n].float() - f32[n]).abs().max().item()
                        d_sdpa = (sdpa[n].float() - f32[n]).abs().max().item()
                        corr = bf16_agreement_stats(got[n], sdpa[n], f32[n])[2]
                        stats[n] = dict(ring_to_f32=d_ring, sdpa_to_f32=d_sdpa, corr=corr)
                        ok_bwd &= d_ring <= BF16_REF_FACTOR * d_sdpa and corr > BF16_ATTN_GRAD_CORR
                    row.update(max_abs_err_vs_f32=err_ref, off_ulp_share=share,
                               max_abs_err_vs_kernel=d_kern.max().item(), grads=stats)
                if time_it and not masked and torch.device(dev).type == "cuda":
                    row["ring_fwd_ms"] = time_ms(lambda: ring_blocks_forward(q, k, v, mask,
                                                                             sp=sp),
                                                 reps=3, iters=3)
                    row["ring_bwd_ms"] = time_ms(lambda: ring_blocks_backward(
                        q, k, v, dout.to(dtype), mask, sp=sp), reps=3, iters=3)
                    row["kernel_ms"] = time_ms(lambda: fused_attention(q, k, v, key_mask=mask))
                log("ring " + json.dumps(row))
                if not (ok_fwd and ok_bwd) or not np.isfinite(out.float().cpu().numpy()).all():
                    raise AssertionError(f"ring at sp={sp} {row['shape']} {dname} "
                                         f"masked={masked}: forward {ok_fwd}, backward {ok_bwd}")
                rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Phase 34: the quality harnesses (``ezaudio_tpu_torch/validation/``) on the
# card: (a) the toy harness at its widths (depth 4, dim 128, 4 heads x 32,
# 64 frames, 4 text tokens), training cut to HARNESS_TOY_STEPS, then a
# DDIM-25 and a DPM-10 row at HARNESS_TOY_EVAL samples; (b) the mid harness
# at s3_l's widths (dim 1024, 16 heads x 64, 500 frames, 128 channels),
# depth cut to HARNESS_MID_DEPTH: 16 + 8 seeded 10 s clips through the VAE
# encode and the sanity gate, HARNESS_FIT_STEPS steps of the VAE fit (batch
# 4 x 1 s), HARNESS_TEACHER_STEPS teacher steps, DDIM-10 and DPM-10 rows at
# 8 samples with the CLAP columns; (c) the card against the CPU on the same
# weights and inputs: the encoded latents of one batch (8 clips of 1 s) and
# DPM-10's sampled latents at s3_l's widths, depth 2, 2 samples of
# HARNESS_CVC_FRAMES frames.  Each within its limit of the CPU output's
# largest magnitude: the encode as phase 33 (a)'s batch encode (kernel 2's
# 3xTF32 against f32, TF32 off; that phase reads 6.1e-6), the row as
# phase 9's PIPE_REL_TOL (kernel 1 in every call of a 10-step loop).
HARNESS_TOY_STEPS = 50
HARNESS_TOY_EVAL = 32
HARNESS_MID_DEPTH = 4
HARNESS_FIT_STEPS = 3
HARNESS_TEACHER_STEPS = 5
HARNESS_MID_EVAL = 8
HARNESS_CVC_FRAMES = 100
HARNESS_ENCODE_REL_TOL = 1e-4
HARNESS_ROW_REL_TOL = PIPE_REL_TOL


def harness_want(path: str, depth: int = 4, steps: int = 0, clips: int = 0,
                 layer_cache=None) -> tuple:
    """(kernel 1, kernel 2) launches of a harness path: a train step runs
    one forward of ``depth + 1`` blocks (its backward recomputes the plain
    twin, uncounted); a row runs its sampler's model calls
    (``want_attention``) and decodes ``clips`` samples for the CLAP columns;
    the encode runs 12 units a batch of ENCODE_BATCH clips; a VAE fit step
    runs the encoder and the decoder (24)."""
    from ezaudio_tpu_torch.validation.quality_validate_mid import ENCODE_BATCH

    batches = -(-clips // ENCODE_BATCH)
    if path == "train":
        return 2 * (depth + 1) * steps, 0
    if path == "row":
        return want_attention(depth, steps, layer_cache), 12 * batches
    if path == "encode":
        return 0, 12 * batches
    if path == "fit":
        return 0, 24 * steps
    raise ValueError(path)


def harness_agreement(name: str, got, want, tol: float) -> float:
    """``got`` (card) within ``tol`` of the largest magnitude of ``want``
    (CPU), both finite and of one shape; returns the relative error."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError(f"{name}: shapes {got.shape} {want.shape} or not finite")
    rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    log(f"{name} " + json.dumps(dict(rel_err=rel, tol=tol)))
    if rel > tol:
        raise AssertionError(f"{name}: card against CPU {rel:.3e} > {tol}")
    return rel


def harness_path(name, dev, fn, want):
    """Drive one harness path between a counter reset and a read; check
    its launches against ``want`` (kernel 1, kernel 2)."""
    import torch

    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    seen = set()
    reset_counters()
    with resunit_shapes(seen):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    row = dict(path=name, wall_s=wall, attention_launches=attn, resunit_launches=res,
               want=list(want), resunit_shapes=sorted(seen, reverse=True),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
    log(f"{name} " + json.dumps(row))
    if (attn, res) != tuple(want):
        raise AssertionError(f"{name}: launch counts {attn}, {res}: want {want}")
    row["out"] = out
    return row


def _harness_row(name, out, shape, extra):
    import numpy as np

    if tuple(out.shape) != tuple(shape) or not np.isfinite(out).all() or not all(
            np.isfinite(v) for v in extra.values()):
        raise AssertionError(f"{name}: output {out.shape} (want {shape}) or a score not finite: "
                             f"{extra}")
    log(f"{name} scores " + json.dumps(extra))


def toy_harness_paths(dev="cuda", steps=HARNESS_TOY_STEPS, n_eval=HARNESS_TOY_EVAL,
                      model_cfg=None):
    """Phase 34 (a): ``quality_validate``'s training loop and two rows."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.audio.metrics import frechet_audio_distance
    from ezaudio_tpu_torch.validation import quality_validate as qv
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    cfg = model_cfg or qv.MODEL_CFG
    sched = qv.schedule()
    model = qv.seeded_maskdit(cfg, 0, dev)
    rng = np.random.default_rng(0)
    depth = cfg["depth"]
    rows = [harness_path("harness_toy_train", dev,
                         lambda: qv.train_toy(model, sched, steps, rng, dev, log_every=50),
                         harness_want("train", depth, steps))]
    if not np.isfinite(rows[0]["out"]).all():
        raise AssertionError(f"toy training losses {rows[0]['out']}")
    lat_ref, txt_eval, cls_eval = qv.make_batch(rng, n_eval)
    txt = torch.as_tensor(txt_eval, device=dev)
    noise = qv.eval_noise((n_eval, qv.L, qv.C), dev)
    for name, builder, n in (("DDIM-25", qvm.ddim(sched, 25), 25),
                             ("DPM-10", qvm.dpm(sched, 10), 10)):
        row = harness_path(f"harness_toy_{name}", dev,
                           lambda b=builder: qvm.run_config(model, b, noise, txt, n_eval),
                           harness_want("row", depth, n))
        out = row["out"]
        _harness_row(row["path"], out, (n_eval, qv.L, qv.C),
                     dict(fad=frechet_audio_distance(qv.features(out), qv.features(lat_ref)),
                          acc=qv.class_accuracy(out, cls_eval)))
        rows.append(row)
    return rows


def mid_harness_args(dev, root, depth=HARNESS_MID_DEPTH, n_eval=HARNESS_MID_EVAL, extra=()):
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    return qvm.parse_args(["--depth", str(depth), "--dim", "1024", "--heads", "16",
                           "--frames", "500", "--n-train", "16", "--n-eval", str(n_eval),
                           "--eval-chunk", str(n_eval), "--vae-steps", str(HARNESS_FIT_STEPS),
                           "--cache", "0", "--cache-root", root, "--device", str(dev),
                           *extra])


def mid_harness_paths(dev="cuda", root=None, args=None, vae_config=None, clap_config=None):
    """Phase 34 (b): ``quality_validate_mid``'s stages at s3_l's widths."""
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    a = args or mid_harness_args(dev, root)
    h = qvm.MidHarness(a, dev, vae_config, clap_config)
    depth, n_eval = a.depth, a.n_eval
    rows = [harness_path("harness_mid_encode", dev, h.encode,
                         (0, harness_want("encode", clips=a.n_train)[1]
                          + harness_want("encode", clips=n_eval)[1]))]
    acc = h.gate()
    rows[0]["readout_acc"] = acc
    log("harness_mid_gate " + json.dumps(dict(readout_acc=acc, limit=qvm.MIN_READOUT_ACC,
                                              clips=n_eval)))
    rows.append(harness_path("harness_mid_vae_fit", dev, h.fit_vae,
                             harness_want("fit", steps=a.vae_steps)))
    rows.append(harness_path("harness_mid_teacher", dev,
                             lambda: h.train("diffusion", HARNESS_TEACHER_STEPS, seed=0),
                             harness_want("train", depth, HARNESS_TEACHER_STEPS)))
    diff = rows[-1].pop("out")
    rows.append(harness_path("harness_mid_clap_ref", dev, h.setup_clap,
                             harness_want("encode", clips=n_eval)))
    for name, builder in (("DDIM-10", qvm.ddim(h.sched, 10)), ("DPM-10", qvm.dpm(h.sched, 10))):
        row = harness_path(f"harness_mid_{name}", dev,
                           lambda builder=builder: h.timed_row(name, diff, builder),
                           harness_want("row", depth, 10, clips=n_eval))
        _, fad, acc_row, cscore, cfad = h.rows[-1]
        _harness_row(row["path"], row.pop("out"), (n_eval, a.frames, h.C),
                     dict(fad=fad, acc=acc_row, clap_score=cscore, clap_fad=cfad))
        rows.append(row)
    del diff, h
    return rows


def harness_card_vs_cpu(dev="cuda", vae_config=None, model_cfg=None, frames=HARNESS_CVC_FRAMES,
                        n=2, clips=8, clip_frames=50):
    """Phase 34 (c): one encode batch and one DPM-10 row, card against CPU."""
    import torch

    from ezaudio_tpu_torch.validation import quality_validate as qv
    from ezaudio_tpu_torch.validation import quality_validate_mid as qvm

    lat = {}
    for d in (dev, "cpu"):
        facade, sr, ratio = qvm.make_vae(d, vae_config)
        lat[d] = qvm.encode_dataset(clips, 0, facade, sr, ratio, clip_frames)[0]
        del facade
    enc = harness_agreement("harness_encode_card_vs_cpu", lat[dev], lat["cpu"],
                            HARNESS_ENCODE_REL_TOL)
    cfg = model_cfg or qvm.model_config(2, 1024, 16, frames, 128, False)
    sched = qv.schedule()
    out = {}
    for d in (dev, "cpu"):
        model = qv.seeded_maskdit(cfg, 0, d).eval().requires_grad_(False)
        noise = qv.eval_noise((n, frames, cfg["in_chans"]), d)
        txt = torch.as_tensor(qvm.class_text(torch.arange(n).numpy() % qvm.N_CLASS), device=d)
        out[d] = qvm.run_config(model, qvm.dpm(sched, 10), noise, txt, n)
        del model
    row = harness_agreement("harness_dpm10_card_vs_cpu", out[dev], out["cpu"],
                            HARNESS_ROW_REL_TOL)
    return dict(encode_rel_err=enc, row_rel_err=row)


def harness_paths(dev="cuda", root=None):
    """Phase 34: (a), (b) and (c); returns the paths' rows."""
    rows = toy_harness_paths(dev) + mid_harness_paths(dev, root)
    for r in rows:
        r.pop("out", None)
    harness_card_vs_cpu(dev)
    return rows


# Phase 35: the mid product harnesses (``validation/{mid_common,
# distill_serve_mid,quality_edit_controlnet_mid,verify_checkpoints}.py``) at
# EzAudio-Mid's widths (dim 512, 8 heads x 64, vae.json's VAE, the tiny T5),
# depth cut to PRODUCT_DEPTH, counts cut as below (the scripts': 1500 fit
# steps, 1024 + 128 clips, 4000 teacher and 2 x 1500 distillation steps at
# batch 16, 128 prompts served at batch 16 with the teacher at DDIM-100, 48 +
# 24 edits at 50 steps, 1500 ControlNet steps on 512 clips, 32 + 32 samples
# at 50 steps).  (c) holds the card against the CPU at 4 clips of 1 s (the
# CPU encodes one 10 s clip of vae.json's VAE in ~9 s): the encode within
# HARNESS_ENCODE_REL_TOL, the decode -> encode round trip within
# PIPE_REL_TOL of the CPU output's largest magnitude; verify_checkpoints'
# reports with equal counts, the SI-SDR within PRODUCT_SDR_ATOL dB (f32) and
# the bf16 DiT's t-delta within PRODUCT_T_DELTA_REL of the CPU's (a mean of
# 1.3e5 bf16 differences; the card's and the CPU's bf16 sums round apart).
PRODUCT_DEPTH = 2
PRODUCT_FIT_STEPS = 2
PRODUCT_TEACHER_STEPS = 5
PRODUCT_DISTILL_STEPS = 2
PRODUCT_BATCH = 4
PRODUCT_TRAIN, PRODUCT_EVAL = 16, 8
PRODUCT_SERVE = 4
PRODUCT_TEACHER_DDIM = 10
PRODUCT_EDITS = 2
PRODUCT_EDIT_STEPS = 10
PRODUCT_CN_TRAIN = 8
PRODUCT_CN_STEPS = 3
PRODUCT_CVC_CLIPS, PRODUCT_CVC_FRAMES = 4, 50
PRODUCT_SDR_ATOL = 1e-2
PRODUCT_T_DELTA_REL = 2e-2


def product_want(path: str, depth: int, steps: int = 0, clips: int = 0, batches: int = 1,
                 edits: int = 0, n_eval: int = 0) -> tuple:
    """(kernel 1, kernel 2) launches of a phase-35 path.  A model call runs
    depth + 1 blocks, two attentions each (a CFG pair is one call); the
    ControlNet adds its depth // 2 in-blocks; a distillation step makes
    three calls (the teacher's two, the student's); a decode or encode call
    runs 12 ResidualUnits, a clip chunk of 8 (``mid_common.ENCODE_CHUNK``)
    at a time, a served batch of up to 4 clips in one call."""
    blocks, half = depth + 1, depth // 2
    chunks = -(-clips // 8)
    if path == "distill":
        return 6 * blocks * steps, 0
    if path == "serve":   # ``batches`` generate calls of ``steps`` model calls, then scored
        return 2 * blocks * steps * batches, 12 * batches + 12 * chunks
    if path == "roundtrip":
        return 0, 24 * chunks
    if path == "edit_rows":
        # three runs of ``edits`` edits (class-changing, crossfaded,
        # same-class), each edit its window's encode, sampler and decode;
        # each run's edited and gt clips encoded; the eval latents' round
        # trip; the target-class clips encoded
        per_run = -(-edits // 8)
        return (2 * blocks * steps * 3 * edits,
                24 * 3 * edits + 24 * 3 * per_run + 24 * -(-n_eval // 8) + 12 * per_run)
    if path == "cn_call":   # one call through the ControlNet, ``clips`` scales
        return 2 * (blocks + half) * clips, 0
    if path == "cn_train":
        return 2 * (blocks + half) * steps, 0
    if path == "cn_eval":   # one ControlNet sample and one t2a sample, decoded
        return 2 * (blocks + half) * steps + 2 * blocks * steps, 24
    if path == "verify":    # verify_vae's encode and decode, verify_dit's two calls
        return 2 * 2 * blocks, 24
    raise ValueError(path)


def product_args(root, depth=PRODUCT_DEPTH, dim=512, heads=8, frames=500,
                 fit_steps=PRODUCT_FIT_STEPS):
    """The two harnesses' arguments at phase 35's cut."""
    from ezaudio_tpu_torch.validation import distill_serve_mid as ds
    from ezaudio_tpu_torch.validation import quality_edit_controlnet_mid as qc

    shared = ["--depth", str(depth), "--dim", str(dim), "--heads", str(heads), "--frames",
              str(frames), "--train-steps", str(PRODUCT_TEACHER_STEPS), "--batch",
              str(PRODUCT_BATCH), "--n-train", str(PRODUCT_TRAIN), "--vae-steps",
              str(fit_steps), "--cache-root", root]
    a = ds.parse_args(shared + ["--n-eval", str(PRODUCT_EVAL), "--distill-steps",
                                str(PRODUCT_DISTILL_STEPS), "--serve-batch", str(PRODUCT_SERVE)])
    q = qc.parse_args(shared + ["--n-edit", str(PRODUCT_EDITS), "--n-same", str(PRODUCT_EDITS),
                                "--edit-steps", str(PRODUCT_EDIT_STEPS), "--cn-steps",
                                str(PRODUCT_CN_STEPS), "--n-cn-train", str(PRODUCT_CN_TRAIN)])
    return a, q


def distill_serve_paths(dev, a, vae_config=None):
    """Phase 35 (a): ``distill_serve_mid``'s pipeline at ``a``'s cut.
    Returns the paths' rows, the teacher's weights and (b)'s model config."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.validation import distill_serve_mid as ds
    from ezaudio_tpu_torch.validation import mid_common as mc
    from ezaudio_tpu_torch.validation.quality_validate_mid import features

    ez, cfg, model_cfg, _ = mc.build_mid_ezaudio(a.depth, a.dim, a.heads, a.frames, device=dev,
                                                 vae_config=vae_config)
    d = a.depth
    rows = [harness_path("product_vae_fit", dev,
                         lambda: mc.fit_vae(ez, steps=a.vae_steps, cache_root=a.cache_root),
                         harness_want("fit", steps=a.vae_steps))]
    rows.append(harness_path("product_data", dev,
                             lambda: mc.prepare_data(ez, a.frames, a.n_train, a.n_eval,
                                                     cache_root=a.cache_root),
                             (0, harness_want("encode", clips=a.n_train)[1]
                              + harness_want("encode", clips=a.n_eval)[1])))
    data = rows[-1].pop("out")
    rows.append(harness_path("product_teacher", dev,
                             lambda: mc.train_teacher(ez, model_cfg, data, a.train_steps,
                                                      a.batch, cache_root=a.cache_root,
                                                      log_every=1),
                             harness_want("train", d, a.train_steps)))
    teacher = rows[-1].pop("out")
    before = snapshot(teacher)
    sched = ez.noise_scheduler
    rows.append(harness_path("product_distill", dev,
                             lambda: ds.distill(teacher, data, sched, a, log_every=1),
                             product_want("distill", d, steps=2 * a.distill_steps)))
    student = rows[-1].pop("out")
    moved = unchanged(teacher, before)
    loaded, meta = ds.save_student(a.ckpt, student, model_cfg, data["mu"], data["sd"])
    saved = snapshot(student)
    reloaded = loaded.state_dict()
    bit_equal = set(reloaded) == set(saved) and all(
        torch.equal(reloaded[k], v) for k, v in saved.items())
    want_meta = dict(distilled_steps=4, guidance=mc.GUIDANCE, latent_mu=data["mu"],
                     latent_sd=data["sd"])
    log("product_student " + json.dumps(dict(teacher_moved=moved, reload_bit_equal=bit_equal,
                                             meta=meta)))
    if moved or not bit_equal or meta != want_meta:
        raise AssertionError(f"distillation moved the teacher ({moved[:3]}), or the reloaded "
                             f"student differs (bit-equal {bit_equal}, meta {meta})")
    del student
    rows.append(harness_path("product_roundtrip", dev,
                             lambda: mc.roundtrip_latents(ez, data["m_eval"], data["mu"],
                                                          data["sd"]),
                             product_want("roundtrip", d, clips=a.n_eval)))
    feats_ref = features(rows[-1].pop("out"))
    cls = data["cls_eval"][:a.serve_batch]
    prompts = [mc.PROMPTS[c] for c in cls]
    length_s = a.frames / ez.latent_sr
    served = {}
    for name, steps, kw in (("teacher", PRODUCT_TEACHER_DDIM,
                             dict(ddim_steps=PRODUCT_TEACHER_DDIM, guidance_scale=mc.GUIDANCE,
                                  guidance_rescale=0.0)),
                            ("student", 4, dict(sampler="distilled", ddim_steps=4))):
        ez.dit.load_state_dict(before if name == "teacher" else reloaded)
        box = {}

        def run(kw=kw, box=box):
            wavs, wall, stats = ds.serve(ez, prompts, length_s, a.serve_batch, **kw)
            box.update(stats=stats, wall=wall)
            return wavs, ds.score(ez, wavs, data, feats_ref, cls)

        # the server's batches decide the count: run, then check against them
        seen = set()
        reset_counters()
        with resunit_shapes(seen):
            t0 = time.perf_counter()
            wavs, (fad, acc) = run()
            sync(dev)
            wall = time.perf_counter() - t0
        attn, res = read_counters()
        want = product_want("serve", d, steps=steps, clips=len(prompts),
                            batches=box["stats"]["batches"])
        row = dict(path=f"product_served_{name}", wall_s=wall, attention_launches=attn,
                   resunit_launches=res, want=list(want), stats=box["stats"],
                   audio_s_per_s=len(prompts) * length_s / box["wall"], fad=fad, acc=acc,
                   resunit_shapes=sorted(seen, reverse=True))
        log(row["path"] + " " + json.dumps(row))
        if (attn, res) != want or not np.isfinite(wavs).all() or not np.isfinite(fad):
            raise AssertionError(f"{row['path']}: launches {attn}, {res} (want {want}), "
                                 f"finite {np.isfinite(wavs).all()}, FAD {fad}")
        served[name] = wavs
        rows.append(row)
    # the served student (ez.dit holds it now) against a direct call for seed 0
    direct = run_path("product_student_direct", dev,
                      lambda: ez.generate_audio(prompts[0], length=length_s,
                                                sampler="distilled", ddim_steps=4,
                                                random_seed=0)[1],
                      2 * (d + 1) * 4, 12, length_s, served["student"].shape[1])
    agreement("product_served_vs_direct", served["student"][0], direct.pop("wav"), {})
    rows.append(direct)
    del ez, teacher, loaded
    return rows, before, model_cfg


def controlnet_outputs(cn_api, data, cond, frames: int):
    """One model call through the ControlNet at conditioning scale 1 and at
    0 on fixed inputs (``data``'s first prompt, the first curve of
    ``cond``): the base's outputs, (2, frames, C)."""
    import torch

    ez = cn_api.base
    dev = ez.device
    x = torch.randn(1, frames, ez.latent_dim, generator=torch.Generator().manual_seed(35)).to(dev)
    t = torch.tensor([500], device=dev)
    ctx = torch.as_tensor(data["cond_emb"][:1], device=dev)
    cm = torch.as_tensor(data["cond_mask"][:1], device=dev)
    condition = torch.as_tensor(cond[:1], device=dev)
    outs = []
    with torch.inference_mode():
        concat, _ = ez.dit(x, t, ctx, context_mask=cm, forward_model=False)
        for scale in (1.0, 0.0):
            skips = cn_api.controlnet(concat, t, ctx, context_mask=cm, condition=condition,
                                      conditioning_scale=scale)
            outs.append(ez.dit.forward_backbone(concat, t, ctx, context_mask=cm,
                                                controlnet_skips=skips))
    return torch.cat(outs, 0)


def edit_controlnet_paths(dev, q, teacher, vae_config=None):
    """Phase 35 (b): ``quality_edit_controlnet_mid`` at ``q``'s cut on (a)'s
    cached VAE, data and teacher (no launches: every cache hits).  Returns
    the rows, the ControlNet and the run's data."""
    import numpy as np
    import torch

    from ezaudio_tpu_torch.validation import mid_common as mc
    from ezaudio_tpu_torch.validation import quality_edit_controlnet_mid as qc

    ez, cfg, model_cfg, _ = mc.build_mid_ezaudio(q.depth, q.dim, q.heads, q.frames,
                                                 with_controlnet=True, device=dev,
                                                 vae_config=vae_config)
    d = q.depth
    n_eval = PRODUCT_EVAL
    rows = [harness_path("product_cached_vae", dev,
                         lambda: mc.fit_vae(ez, steps=q.vae_steps, cache_root=q.cache_root),
                         (0, 0))]
    rows.append(harness_path("product_cached_data", dev,
                             lambda: mc.prepare_data(ez, q.frames, q.n_train, n_eval,
                                                     cache_root=q.cache_root), (0, 0)))
    data = rows[-1].pop("out")
    rows.append(harness_path("product_cached_teacher", dev,
                             lambda: mc.train_teacher(ez, model_cfg, data, q.train_steps,
                                                      q.batch, cache_root=q.cache_root),
                             (0, 0)))
    differ = unchanged(rows[-1].pop("out"), teacher)
    if differ:
        raise AssertionError(f"the cached teacher differs from (a)'s: {differ[:3]}")
    h = qc.Harness(ez, data, q)
    rows.append(harness_path("product_edit_rows", dev, h.edit_rows,
                             product_want("edit_rows", d, steps=q.edit_steps,
                                          edits=q.n_edit, n_eval=n_eval)))
    edit = rows[-1].pop("out")
    cn_api = h.controlnet()
    rng = np.random.default_rng(3)
    rows.append(harness_path("product_cn_data", dev,
                             lambda: h.controlnet_data(cn_api, rng, q.n_cn_train),
                             harness_want("encode", clips=q.n_cn_train)))
    cn_cls, cn_lat, cn_cond = rows[-1].pop("out")
    rows.append(harness_path("product_cn_start", dev,
                             lambda: controlnet_outputs(cn_api, data, cn_cond, q.frames),
                             product_want("cn_call", d, clips=2)))
    start = rows[-1].pop("out")
    rows.append(harness_path("product_cn_train", dev,
                             lambda: h.train_controlnet(cn_api, ez.noise_scheduler, q.cn_steps,
                                                        rng, cn_cls, cn_lat, cn_cond,
                                                        log_every=1),
                             product_want("cn_train", d, steps=q.cn_steps)))
    rows.append(harness_path("product_cn_trained", dev,
                             lambda: controlnet_outputs(cn_api, data, cn_cond, q.frames),
                             product_want("cn_call", d, clips=2)))
    trained = rows[-1].pop("out")
    rows.append(harness_path("product_cn_eval", dev, lambda: h.controlnet_eval(cn_api, 1),
                             product_want("cn_eval", d, steps=q.edit_steps)))
    r = rows[-1].pop("out")
    checks = dict(start_scale_diff=float((start[0] - start[1]).abs().max()),
                  trained_scale_diff=float((trained[0] - trained[1]).abs().max()),
                  **{k: v for k, v in {**edit, **r}.items()})
    log("product_edit_controlnet " + json.dumps(checks))
    if not (torch.equal(start[0], start[1]) and checks["trained_scale_diff"] > 0
            and all(np.isfinite(v) for v in checks.values())):
        raise AssertionError(f"ControlNet scale 1 against 0 or a row: {checks}")
    return rows, cn_api, data


def product_card_vs_cpu(dev, cn_api, data, vae_cfg, root, clips=PRODUCT_CVC_CLIPS,
                        frames=PRODUCT_CVC_FRAMES):
    """Phase 35 (c): the encode and the round trip of ``clips`` clips of
    ``frames`` latent frames, and ``verify_checkpoints`` on reference-format
    files of ``cn_api``'s models, card against CPU."""
    import types

    import numpy as np
    import torch

    from ezaudio_tpu_torch.codecs.facade import AutoencoderFacade
    from ezaudio_tpu_torch.codecs.oobleck import vae_from_config
    from ezaudio_tpu_torch.validation import mid_common as mc
    from ezaudio_tpu_torch.validation import verify_checkpoints as vc
    from ezaudio_tpu_torch.validation.quality_validate_mid import synth_clip

    ez = cn_api.base
    cpu_vae = vae_from_config(vae_cfg).eval().requires_grad_(False)
    cpu_vae.load_state_dict({k: v.cpu() for k, v in ez.autoencoder.model.state_dict().items()})
    cpu = types.SimpleNamespace(autoencoder=AutoencoderFacade(cpu_vae))
    rng = np.random.default_rng(35)
    ratio = ez.sr // ez.latent_sr
    wavs = np.stack([mc.peak_wav(synth_clip(rng, int(c), frames * ratio, ez.sr))
                     for c in rng.integers(0, len(mc.PROMPTS), clips)])
    d = ez.params_cfg.model.depth
    rows = [harness_path("product_cvc_encode", dev, lambda: mc.encode(ez, wavs),
                         harness_want("encode", clips=clips))]
    z = rows[-1].pop("out")
    res = dict(encode_rel_err=harness_agreement("product_encode_card_vs_cpu", z,
                                                mc.encode(cpu, wavs), HARNESS_ENCODE_REL_TOL))
    m = (z - data["mu"]) / data["sd"]
    rows.append(harness_path("product_cvc_roundtrip", dev,
                             lambda: mc.roundtrip_latents(ez, m, data["mu"], data["sd"]),
                             product_want("roundtrip", d, clips=clips)))
    res["roundtrip_rel_err"] = harness_agreement(
        "product_roundtrip_card_vs_cpu", rows[-1].pop("out"),
        mc.roundtrip_latents(cpu, m, data["mu"], data["sd"]), PIPE_REL_TOL)
    os.makedirs(root, exist_ok=True)
    paths = write_checkpoints(cn_api, root)
    model_cfg = ez.params_cfg.model.to_dict()

    def verify(device):
        return dict(vae=vc.verify_vae(paths["vae_path"], vae_cfg, sine_seconds=1.0,
                                      device=device),
                    dit=vc.verify_dit(paths["ckpt_path"], model_cfg, device=device))

    rows.append(harness_path("product_verify", dev, lambda: verify(dev),
                             product_want("verify", d)))
    card, host = rows[-1].pop("out"), verify("cpu")
    cn = vc.verify_controlnet(paths["controlnet_path"], model_cfg,
                              ez.params_cfg.controlnet.to_dict())
    sdr = abs(card["vae"]["roundtrip_si_sdr_db"] - host["vae"]["roundtrip_si_sdr_db"])
    t_rel = (abs(card["dit"]["t_conditioning_delta"] - host["dit"]["t_conditioning_delta"])
             / host["dit"]["t_conditioning_delta"])
    res.update(verify_card=card, verify_cpu=host, verify_controlnet=cn, sdr_diff_db=sdr,
               t_delta_rel=t_rel, verdicts=dict(
                   vae="OK" if card["vae"]["roundtrip_ok"] else "SUSPICIOUS",
                   dit="OK" if card["dit"]["t_conditioning_live"] else "SUSPICIOUS"))
    log("product_card_vs_cpu " + json.dumps(res))
    counts = [(r["converted_params"], r["reference_tensors"])
              for x in (card, host) for r in x.values()]
    if not (counts[:2] == counts[2:] and card["dit"]["count_ok"] and cn["count_ok"]
            and sdr <= PRODUCT_SDR_ATOL and t_rel <= PRODUCT_T_DELTA_REL
            and all(r["finite"] for x in (card, host) for r in x.values())):
        raise AssertionError(f"verify_checkpoints card against CPU: {res}")
    return rows, res


def product_paths(dev="cuda", root=None, vae_config=None, depth=PRODUCT_DEPTH, dim=512,
                  heads=8, frames=500, fit_steps=PRODUCT_FIT_STEPS, attn_cases=ATTN_CASES):
    """Phase 35: (a), (b) and (c) under one fresh cache root; every
    attention shape must be among ``attn_cases`` (phase 3's).  Returns the
    paths' rows."""
    from ezaudio_tpu_torch.validation.quality_validate_mid import vae_json

    a, q = product_args(root, depth, dim, heads, frames, fit_steps)
    seen = set()
    with attention_shapes(seen):
        with phase("35 (a) distill and serve"):
            rows, teacher, _ = distill_serve_paths(dev, a, vae_config)
        with phase("35 (b) editing and ControlNet"):
            more, cn_api, data = edit_controlnet_paths(dev, q, teacher, vae_config)
        rows += more
        with phase("35 (c) card against CPU"):
            more, _ = product_card_vs_cpu(dev, cn_api, data, vae_config or vae_json(),
                                          os.path.join(root, "ckpt"))
        rows += more
    del cn_api
    missing = uncovered_attention(seen, attn_cases)
    log("product_attention_shapes " + json.dumps(sorted(seen)))
    if missing:
        raise AssertionError(f"attention shapes of phase 35 not in phase 3: {missing}")
    for r in rows:
        r.pop("out", None)
    return rows


# ---------------------------------------------------------------------------
# Phase 36: the load harnesses (validation/{serving_bench,fused_ab}.py) on
# the scripts' model, s3_xl in bf16 with the tiny T5, through their mains;
# cut (the scripts' in brackets): LOAD_STEPS steps (100; 25 and 100 in
# fused_ab), one rate for LOAD_WINDOW_S s (0.5, 1 and 2 req/s for 60 s),
# batches of up to LOAD_MAX_BATCH (8), fused_ab at batch LOAD_AB_BATCH (4).
# --mixed serves 5 s and 10 s requests: the 5 s bucket's attention and
# decode shapes are among phase 3's.
LOAD_STEPS = 3
LOAD_RATE = 2.0
LOAD_WINDOW_S = 4.0
LOAD_MAX_BATCH = 2
LOAD_AB_BATCH = 2


def load_call_launches(depth: int, want_res: int, batch: int, kw: dict):
    """(kernel 1, kernel 2) launches of one ``generate_audio`` call with
    ``kw``: the bf16-logit attention variants are plain torch; the decode
    runs ``want_res`` units a chunk of up to 4 clips."""
    plain = kw.get("attn_impl") in ("bf16", "chunked_bf16")
    attn = 0 if plain else want_attention(depth, kw.get("ddim_steps", 100), kw.get("layer_cache"))
    return attn, want_res * -(-batch // 4)


@contextlib.contextmanager
def counted_calls(ez, calls: list):
    """Append ``(batch, kwargs)`` of every ``ez.generate_audio`` call to
    ``calls`` (the server's and the harness's alike)."""
    real = ez.generate_audio

    def counted(text, *args, **kw):
        calls.append((1 if isinstance(text, str) else len(text), kw))
        return real(text, *args, **kw)

    ez.generate_audio = counted
    try:
        yield
    finally:
        del ez.generate_audio  # no cycle through the instance (ROADMAP F8)


def load_harness_run(name, ez, fn, want_res, attn_cases=ATTN_CASES):
    """Drive one load harness between a counter reset and a read: every
    staged call's launches must be what its recipe and batch imply, every
    new fused program's per replay too, and every launch bf16 when the
    model is.  Launches: the staged calls' and the replays'; a program's
    warm-up and capture move the counters without running on the card."""
    import torch

    depth = ez.params_cfg.model.depth
    cuda = torch.device(ez.device).type == "cuda"
    calls, seen, attn_seen = [], set(), set()
    before = {k: p.replays for k, p in ez._fused.items()}
    sync(ez.device)
    reset_counters()
    with counted_calls(ez, calls), resunit_shapes(seen), attention_shapes(attn_seen):
        t0 = time.perf_counter()
        out = fn()
        sync(ez.device)
        wall = time.perf_counter() - t0
    attn, res = read_counters()
    by_dtype = read_dtype_counters()
    graphs = cuda and any(kw.get("fused") for _, kw in calls)
    staged = [load_call_launches(depth, want_res, b, kw) for b, kw in calls
              if not (graphs and kw.get("fused"))]
    want = [sum(x[0] for x in staged), sum(x[1] for x in staged)]
    launches = list(want)
    if graphs:
        fused = {load_call_launches(depth, want_res, b, kw) for b, kw in calls if kw.get("fused")}
        for k, p in ez._fused.items():
            n = p.replays - before.get(k, 0)
            if n and not any(p.launches == {"attention": a, "resunit": r} for a, r in fused):
                raise AssertionError(f"{name}: launches per replay {p.launches}")
            if k not in before:  # its warm-up and capture passed through the wrappers
                want[0] += 2 * p.launches["attention"]
                want[1] += 2 * p.launches["resunit"]
            launches[0] += n * p.launches["attention"]
            launches[1] += n * p.launches["resunit"]
    row = dict(path=name, wall_s=wall, calls=len(calls), attention_launches=launches[0],
               resunit_launches=launches[1], counters=[attn, res], want_counters=want,
               launches_by_dtype=by_dtype, resunit_shapes=sorted(seen, reverse=True),
               attention_shapes=sorted(attn_seen))
    log(f"{name} " + json.dumps(row))
    if [attn, res] != want:
        raise AssertionError(f"{name}: counters {attn}, {res}: want {want}")
    dt = str(ez.dtype).rsplit(".", 1)[-1]
    if any(not k.endswith("." + dt) for k in by_dtype):
        raise AssertionError(f"{name}: launches by dtype {by_dtype}, want all {dt}")
    missing = uncovered_attention(attn_seen, attn_cases)
    if missing:
        raise AssertionError(f"{name}: attention shapes not in phase 3: {missing}")
    row["out"] = out
    return row


def load_harness_paths(dev="cuda", ez=None, steps=LOAD_STEPS, length=10.0,
                       rate=LOAD_RATE, window=LOAD_WINDOW_S, max_batch=LOAD_MAX_BATCH,
                       ab_batch=LOAD_AB_BATCH, attn_cases=ATTN_CASES):
    """Phase 36: (a) ``serving_bench`` at the reference recipe cut to
    ``steps`` DDIM steps, ``--mixed`` (requests of ``length`` / 2 and
    ``length`` s), one ``rate`` for ``window`` s, batches of up to
    ``max_batch``: every request served; (b) ``fused_ab`` at batch
    ``ab_batch``, both recipes cut to ``steps``: each fused waveform equal
    to the staged one (the module raises otherwise).  ``ez`` defaults to
    the scripts' model (``serving_bench.build_ezaudio``); every attention
    shape must be among ``attn_cases`` (phase 3's)."""
    from ezaudio_tpu_torch.codecs.oobleck import ResidualUnit
    from ezaudio_tpu_torch.validation import fused_ab
    from ezaudio_tpu_torch.validation import serving_bench as sb

    if ez is None:
        t0 = time.perf_counter()
        ez = sb.build_ezaudio("s3_xl", dev)
        log(f"load: s3_xl bf16 with the tiny T5 built in {time.perf_counter() - t0:.2f} s")
    want_res = sum(isinstance(m, ResidualUnit) for m in ez.autoencoder.model.decoder.modules())
    cut = ["--steps", str(steps), "--length", str(length)]
    served = load_harness_run(
        "load_served", ez,
        lambda: sb.main([str(rate), "--recipe", "default", "--seconds", str(window),
                         "--max-batch", str(max_batch), "--mixed", *cut], ez=ez), want_res,
        attn_cases)
    for r in served.pop("out"):
        served.update(sent=r["sent"], served=r["served"], slot_fill=r["slot_fill"],
                      p50_s=r["p50_s"], p99_s=r["p99_s"], batches=r["batches"])
        if not (r["served"] == r["sent"] > 0 and 0 < r["slot_fill"] <= 1
                and sorted(r["per_length"]) == [length / 2, length]):
            raise AssertionError(f"load_served: {r}")
    ab = load_harness_run("load_fused_ab", ez,
                          lambda: fused_ab.main(["--batch", str(ab_batch), *cut], ez=ez),
                          want_res, attn_cases)
    ab["recipes"] = ab.pop("out")
    if [r["max_abs_err"] for r in ab["recipes"]] != [0.0, 0.0]:
        raise AssertionError(f"load_fused_ab: fused differs from staged: {ab['recipes']}")
    log("load_harnesses " + json.dumps(dict(served={k: served[k] for k in (
        "sent", "served", "slot_fill", "p50_s", "p99_s", "batches")}, fused_ab=ab["recipes"])))
    return [served, ab]


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "attn_fwd" in n:
        return "attention kernel"
    if "resunit_fwd" in n:
        return "resunit kernel"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    if "conv" in n or "cudnn" in n:
        return "conv (cuDNN)"
    return "elementwise / other"


def profile(steps: int = 5, out_dir: str = "chiprun_out") -> None:
    """Device-time breakdown of the main path (s3_l, 10 s, ``steps`` DDIM
    steps), f32 then bf16, staged and ``fused=True`` (a replay of its
    graph), and of one s3_l train step, with torch.profiler: time per
    kernel class, busy share of the wall time, and the top kernels
    (written to ``out_dir``)."""
    os.makedirs(out_dir, exist_ok=True)
    for dtype in ("float32", "bfloat16"):
        profile_dtype(steps, out_dir, dtype)
        profile_train(out_dir, dtype=dtype)


def _breakdown(prof, wall_ms, out_path, **info):
    """Log a profile's device ms by kernel class and busy share; write the
    top kernels to ``out_path``."""
    import torch

    by_class, kernels = {}, []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = (e.self_cuda_time_total if t is None else t) / 1e3  # ms
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + t
        kernels.append((t, e.count, e.key))
    busy = sum(by_class.values())
    row = dict(info, wall_ms=wall_ms, device_busy_ms=busy, busy_share=busy / wall_ms,
               ms_by_class=by_class)
    log("profile " + json.dumps(row))
    kernels.sort(reverse=True)
    with open(out_path, "w") as f:
        f.write(json.dumps(row) + "\n")
        for t, cnt, key in kernels[:40]:
            f.write(f"{t:10.3f} ms {cnt:7d}x  {key[:150]}\n")
    return row


def profile_train(out_dir: str, batch: int = TRAIN_BATCH, dtype: str = "float32") -> dict:
    """Device-time breakdown of one s3_l train step (batch ``batch`` x 10 s,
    full remat, f32 or bf16 mixed precision) on seeded latents and text
    embeddings (in ``dtype``, as the VAE and T5 give them): the step alone,
    without the data, the VAE encode and T5 of ``train_cli``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ezaudio_tpu_torch.api.ezaudio import init_random_
    from ezaudio_tpu_torch.config import get_model_config
    from ezaudio_tpu_torch.diffusion.ddim import DDIMSchedule
    from ezaudio_tpu_torch.models.maskdit import maskdit_from_config
    from ezaudio_tpu_torch.training.trainer import Trainer

    cfg = get_model_config("s3_l").to_dict()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.device("cuda"):
        dit = maskdit_from_config(cfg["model"])
    init_random_(dit, gen)
    dt = getattr(torch, dtype)
    trainer = Trainer.create(dit.train(), DDIMSchedule.from_config(cfg["diff"]),
                             dict(learning_rate=1e-4, warmup=2), dtype=dt)
    lens = torch.tensor([23 + 9 * i for i in range(batch)], device="cuda")
    batch_ = dict(latents=torch.randn(batch, 500, 128, device="cuda", generator=gen).to(dt),
                  text=torch.randn(batch, 100, 1024, device="cuda", generator=gen).to(dt),
                  text_mask=torch.arange(100, device="cuda")[None] < lens[:, None],
                  uncond=torch.randn(1, 100, 1024, device="cuda", generator=gen).to(dt),
                  uncond_mask=torch.arange(100, device="cuda")[None] < 1)
    for _ in range(2):
        trainer.train_step(batch_, 0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch_, 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tag = "" if dtype == "float32" else f"_{dtype}"
    return _breakdown(prof, wall_ms, os.path.join(out_dir, f"profile_train{tag}.txt"),
                      path="train_step", batch=batch, remat="full", dtype=dtype)


def profile_dtype(steps: int, out_dir: str, dtype: str) -> None:
    """:func:`profile` for one dtype, on a model of its own."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ezaudio_tpu_torch.api.ezaudio import EzAudio

    ez = EzAudio("s3_l", device="cuda", seed=0, dtype=getattr(torch, dtype))
    for n, fused in ((1, False), (1, True), (4, False), (4, True)):
        prompts = ["a dog barking in the rain"] * n
        # warm up; the fused warm-up captures the profiled call's graph
        ez.generate_audio(prompts, ddim_steps=steps if fused else 2, random_seed=0,
                          fused=fused)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ez.generate_audio(prompts, ddim_steps=steps, random_seed=0, fused=fused)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        tag = ("_fused" if fused else "") + ("" if dtype == "float32" else f"_{dtype}")
        _breakdown(prof, wall_ms, os.path.join(out_dir, f"profile_{n}prompt{tag}.txt"),
                   prompts=n, fused=fused, dtype=dtype, ddim_steps=steps)


# ---------------------------------------------------------------------------
def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from ezaudio_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs sum in f32, as the JAX package's bf16 products do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} sources compiled in {time.perf_counter() - t0:.2f} s "
        f"into {_build.build_dir()}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")

    if "--profile" in argv:
        profile()
        log("profile: done; no result line")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    with phase("3 kernels"):
        attn_rows = check_attention("cuda", gen)
        res_rows = check_resunit("cuda", gen)
        res_rows += check_resunit("cuda", gen, RESUNIT_BF16_CASES, "bfloat16")
    with phase("23 kernel gradients"):
        check_attention_grad("cuda", gen)
        for case in RESUNIT_GRAD_CASES:
            check_resunit_grad("cuda", gen, case)
    before = mem_gib(torch.cuda.memory_allocated)
    ez = build_ezaudio()
    with phase("4 main"):
        paths = main_path(ez)
    f32_main = paths[:2]
    with phase("5 card_vs_cpu"):
        card_vs_cpu(gen)
    with phase("6-7 editing, long"):
        paths += edit_paths(ez, long_steps=CUT_LONG_STEPS)
    with phase("8 samplers"):
        paths += sampler_paths(ez)
    with phase("9 card_vs_cpu_fast"):
        card_vs_cpu_fast()
    with phase("10 fused"):
        paths += fused_paths(ez, f32_main, replays=CUT_REPLAYS)
    with phase("11 int8"):
        int8_rows, _ = int8_paths(ez, gen, steps=CUT_INT8_STEPS)
    with phase("12 served"):
        served = served_paths(ez, steps=CUT_SERVED_STEPS)
        served_fused = served_paths(ez, fused=True, steps=CUT_SERVED_STEPS)  # captures
        served_replay = served_paths(ez, fused=True, name="served_fused_replay",
                                     steps=CUT_SERVED_STEPS)
        served_checks(ez, served, served_fused, served_replay)
    paths += int8_rows + [served, served_fused, served_replay]

    before_clap = mem_gib(torch.cuda.memory_allocated)
    scorer, ids = build_scorer(), clap_ids()
    with phase("20 rerank"):
        rerank = rerank_path(ez, scorer, ids, steps=CUT_RERANK_STEPS)
        clap_card_vs_cpu(scorer, rerank, ids)
    with phase("21 served rerank"):
        paths += [rerank, served_rerank(ez, scorer, ids, steps=CUT_SERVED_STEPS)]
    del scorer
    check_freed("CLAP scorer", before_clap)
    del ez  # no gc: nothing holds it in a cycle (ROADMAP F8)
    check_freed("s3_l f32", before)

    ez = build_ezaudio(dtype="bfloat16")
    with phase("16 s3_l bf16"):
        paths += bf16_paths(ez, f32_main, replays=CUT_REPLAYS)
    del ez
    check_freed("s3_l bf16", before)
    with phase("17 bf16 card_vs_cpu"):
        bf16_card_vs_cpu(gen)

    cn = build_controlnet()
    with phase("13 controlnet"):
        paths += controlnet_paths(cn)
    with phase("14 controlnet card_vs_cpu"):
        controlnet_card_vs_cpu()
    with phase("15 controlnet served"):
        paths.append(controlnet_served(cn, steps=CUT_SERVED_STEPS))
    with phase("18 checkpoint round trip"):
        checkpoint_round_trip(cn)
    del cn
    check_freed("energy ControlNet", before)
    with phase("19 s3_xl bf16"):
        paths.append(s3_xl_path())
    check_freed("s3_xl bf16", before)
    with phase("22 vc"):
        vc_path()
    check_freed("ContentVec", before)
    with phase("24 train"):
        train = training_path()
        paths.append(train)
    check_freed("s3_l trainer", before)
    check_batch_shapes(train, RESUNIT_CASES)
    with phase("25 train step card_vs_cpu"):
        train_step_card_vs_cpu(gen)
    check_freed("train step card_vs_cpu", before)
    with phase("28 bf16 train"):
        check_attention_grad_bf16("cuda", gen)
        train16 = training_path(dtype="bfloat16")
        paths.append(train16)
        log("train_f32_vs_bf16 " + json.dumps({
            k: [train[k], train16[k]] for k in ("step_wall_s", "samples_per_s", "model_tflops",
                                                "share_of_peak", "peak_mem_gib")}))
    check_freed("s3_l bf16 trainer", before)
    check_batch_shapes(train16, RESUNIT_BF16_CASES)
    with phase("28 bf16 train step card_vs_cpu"):
        bf16_train_card_vs_cpu(gen)
    check_freed("bf16 train step card_vs_cpu", before)
    with phase("26 controlnet train"):
        paths.append(controlnet_train_path())
    check_freed("ControlNet trainer", before)
    with phase("26 controlnet train card_vs_cpu"):
        controlnet_train_card_vs_cpu(gen)
    check_freed("ControlNet train step card_vs_cpu", before)
    ez = build_ezaudio()
    with phase("27 distill"):
        paths.append(distill_path(ez))
    with phase("27 distill card_vs_cpu"):
        distill_card_vs_cpu(gen)
    with phase("29 flow and tools"):
        paths += flow_paths(ez)
        root = tempfile.mkdtemp(prefix="ezaudio_tools_")
        try:
            paths += tool_paths(ez, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    del ez
    check_freed("s3_l distill, flow and tools", before)
    with phase("30a codec train"):
        codec = codec_train_path()
        paths.append(codec)
    check_freed("VAE codec trainer", before)
    with phase("30a codec restart"):
        codec_restart()
    check_freed("codec restart", before)
    check_batch_shapes(codec, RESUNIT_CASES)
    with phase("30a codec step card_vs_cpu"):
        codec_step_card_vs_cpu()
    check_freed("codec step card_vs_cpu", before)
    with phase("30b dac"):
        dac_paths()
    check_freed("DAC", before)
    with phase("30c encodec"):
        encodec_path()
    check_freed("EnCodec", before)
    with phase("30d facade"):
        paths += facade_paths()
    check_freed("facade codecs", before)
    with phase("30e pretransforms"):
        pretransform_paths()
    with phase("31 UDiT variants"):
        paths += variant_paths(before=before, reps=1, replays=CUT_REPLAYS)
    with phase("31 variants card_vs_cpu"):
        variant_card_vs_cpu(gen)
    check_freed("variants card_vs_cpu", before)
    with phase("32 demos, toolkit and Whisper"):
        root = tempfile.mkdtemp(prefix="ezaudio_toolkit_")
        try:
            paths += toolkit_paths(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    check_freed("demos and Whisper", before)
    with phase("33 non-wav, world of one, ring"):
        root = tempfile.mkdtemp(prefix="ezaudio_nonwav_")
        try:
            with phase("33 (a) non-wav"):
                nonwav = nonwav_paths(f32_main[0]["wav"], 24000, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        check_batch_shapes(nonwav, RESUNIT_CASES)
        paths.append(nonwav)
        check_freed("native batch encode", before)
        with phase("33 (b) world of one"):
            world = world_one_paths()
            paths += world[:2] + world[-1:] + [controlnet_nocontext_path()]
        check_freed("world of one", before)
        with phase("33 (c) ring"):
            ring_math("cuda", gen)
    with phase("34 quality harnesses"):
        root = tempfile.mkdtemp(prefix="ezaudio_harness_")
        try:
            harness = harness_paths("cuda", root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        paths += harness
    check_freed("quality harnesses", before)
    with phase("35 mid product harnesses"):
        root = tempfile.mkdtemp(prefix="ezaudio_product_")
        try:
            paths += product_paths("cuda", root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    check_freed("mid product harnesses", before)
    with phase("36 load harnesses"):
        paths += load_harness_paths("cuda")
    check_freed("load harnesses", before)

    missing = uncovered_shapes(paths)
    if missing:
        raise AssertionError(f"ResidualUnit shapes of the paths not checked in phase 3: {missing}")
    launches = [sum(p["attention_launches"] for p in paths),
                sum(p["resunit_launches"] for p in paths)]
    log("launches " + json.dumps({p["path"]: [p["attention_launches"], p["resunit_launches"]]
                                  for p in paths}))

    a = attn_rows[0]   # s3_l self-attention, f32: the main path's shape
    r = next(x for x in res_rows if x["shape"] == [1, 240000, 128] and x["dilation"] == 9)
    kernels = [
        dict(name="attention", route="cuda",
             source="ezaudio_tpu_torch/csrc/attention.cu",
             replaces="ezaudio_tpu/ops/pallas/attention.py:36", launches=launches[0],
             shape=a["shape"], dtype=a["dtype"], max_abs_err=a["max_abs_err"],
             ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
             bound_by=a["bound_by"], library_ms=a["library_ms"]),
        dict(name="resunit", route="cuda",
             source="ezaudio_tpu_torch/csrc/resunit.cu",
             replaces="ezaudio_tpu/ops/pallas/resunit.py:69", launches=launches[1],
             shape=r["shape"] + [r["dilation"]], dtype=r["dtype"],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None),
    ]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
