"""Smoke run of the PyTorch/CUDA port (minimax_speech_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, /usr/local/cuda or PATH);
exits non-zero, printing no result, without them. Phases, each printing
a line; any failure ends the run with a non-zero exit:

  1. device: name, power limit (nvidia-smi), versions; TF32 off for
     matmuls and cuDNN convs, so float32 comparisons are float32;
  2. build: every CUDA source of the port, one nvcc each, in parallel;
     ptxas's registers, shared memory and spills (a spill fails the
     run), and the tensor-core instructions in each attention kernel's
     SASS (cuobjdump; a kernel with none fails the run);
  3. K1 (csrc/flash_attention.cu) against its plain PyTorch version on
     the card, in every mask mode, fp32 and bf16, at the UNet's main-path
     shape and at a ragged T; times of kernel, plain version and
     torch's scaled_dot_product_attention (a yardstick the port never
     calls) at the main-path shape, as CUDA-graph replays (device time
     without the host's launch gaps), and of one eager wrapper call;
  4. the main path at the full width of configs/default.yaml with
     random weights (seed 0): zero-shot synthesis through TTSPipeline's
     entry points, as bench.py drives the JAX package (3 s prompt, 12
     text tokens, 125 generated tokens, LM in bf16 with W8A8 projections
     and random int8 kernels, flow and codec in fp32), with K1's
     launches counted per utterance;
  5. the same synthesis at reduced depth on the card and on the CPU with
     the same weights and noise, the LM in float32: identical token ids,
     PCM within a stated tolerance; then the W8A8 LM (bench.py's random
     int8 kernels, float32 activations): every QuantDense call of the
     CPU's decode replayed on the card, bit-identical, and the decode on
     both giving identical token ids;
  6. K2 (csrc/splash_attention.cu) against its plain PyTorch version on
     the card: forward output and dq, dk, dv, in every mask mode, fp32
     and bf16, at the LM training shape (8, 14, 512, 64) with the
     training batch's lengths and at a ragged T; times of the kernels,
     the plain version and torch's scaled_dot_product_attention (a
     yardstick the port never calls), forward and forward+backward, at
     the LM shape in fp32 causal, as CUDA-graph replays and eager calls;
  7. Stage-1 LM training at the full width of configs/default.yaml
     (random weights, seed 0, fp32, TF32 off) on a fixed batch of 8
     plans padded to 512: 2 warm-up and 5 timed train steps, one
     profiled step, the loss lower after 10 steps, 2 bf16 steps; every
     counted step must launch K2 24 times forward and 24 backward (one
     per layer) and K1 never;
  8. the training entry point, cli/train.main --model llm, at full width
     (PATH_LM_LAYERS layers) for one epoch on a synthetic corpus:
     metrics, a checkpoint, and a second call that resumes at the saved
     step;
  9. LM training at reduced depth (2 layers) on the card and on the CPU
     with the same weights and batch: loss, accuracy, grad norm and the
     parameters after 2 steps within stated tolerances;
 10. the LM's int8 product (torch._int_mm, rows padded past 16) for each
     projection shape at M=1 and M=128: the int32 accumulator equals the
     CPU's exactly; its time beside a bf16 matmul of the same shape;
 11. the synthesis CLI's paths at full width with phase 4's LM cut to
     PATH_LM_LAYERS layers, K1's count set to 0 before each and read
     after: the unfused `synthesize` (also the warm-up), a chunked
     StreamingSession (time to first chunk, total, chunks, audio, K1
     launches in the prefill and per hop) and a non-chunked one (K1's
     chunk-50
     mode per hop); then K1, its plain version and SDPA timed at the
     streaming prefill's shape and at the largest chunk-50 hop's;
 12. streaming at reduced depth: the card's chunked session against its
     own unit-grid pass (flow_inference_unit_grid) within the JAX test's
     limit, and the streamed PCM of the card against the CPU's;
 13. cli/synthesize.main at full width (PATH_LM_LAYERS LM layers),
     unfused and --stream, each writing a wav;
 15. serving at full width, phase 4's LM cut to PATH_LM_LAYERS
     layers: a BatchSynthesizer call of 4
     requests with ragged prompts (2-3.5 s) and texts (50-100 tokens),
     then the longest alone; tokens, lengths, K1's launches per call
     (560, at (2 x 4, ...) with ragged key lengths) and audio seconds
     per wall second at B = 4 and B = 1;
 16. a ContinuousBatcher of 4 slots driven by run() with 6 staggered
     arrivals (simulated clock): each request's latency to its final
     event, every lane flushed, 560 K1 launches (chunk-50 mode) per hop
     call; then a lockstep BatchStreamingSession of 3 requests: each
     stream's time to its first chunk, 560 K1 launches per hop;
 14. K1 at the shapes phases 15 and 16 gave it, (8, 8, T, 64) with the
     requests' ragged key lengths, full and chunk-50 modes, fp32 and
     bf16, against its plain version at phase 3's limits; kernel, plain
     and SDPA times and the bound (run after 15 and 16, whose shapes it
     reads);
 17. cli/serve.py as a subprocess on a free loopback port, once per
     scheduler (window, continuous), at full width (W8A8 LM at
     PATH_LM_LAYERS of its 24 layers, 30 tokens):
     /healthz, a 3 s tone speaker registered, 3 concurrent /synthesize
     requests answered with 24 kHz mono int16 WAVs, bad payloads
     answered with 400; then warm_serving once in-process;
 18. reduced depth (float32 LM, 2 layers), card against CPU with the
     same weights and noise: BatchSynthesizer token ids identical and
     PCM within PCM_TOL_LSB, ContinuousBatcher bursts (a request joining
     mid-decode) and BistreamDecoder token ids identical;
 19. K2 at the flow-training shape (8, 8, 512, 64) with phase 20's key
     lengths, in the UNet's full and chunk-50 modes, fp32 and bf16,
     forward and dq, dk, dv against its plain version at K2_TOL; kernel,
     plain and SDPA times, forward and forward+backward, as CUDA-graph
     replays, beside the bound;
 20. Stage-2 flow training at the full width of configs/default.yaml
     (random weights, seed 0, fp32, TF32 off, AdamW 1e-4, fixed draws)
     on a fixed padding_flow batch of 8 utterances of 160-256 tokens
     (T = 512 latent frames): 2 warm-up and 5 timed steps (median
     step_s, frames/s, peak memory), one profiled step (K2's, the
     GEMMs' and the convolutions' shares of the device's busy time, the
     host's idle share), the loss lower after 10 steps; every step must
     launch K2 56 times forward and 56 backward (one per UNet
     transformer block) and K1 never, also in one streaming=True step
     (K2's chunk-50 mode) and 2 bf16 steps;
 21. cli/train.main --model flow at full width for one epoch on the
     synthetic corpus with a cv pass (no grad: K1 only), then a second
     call that resumes at the saved step;
 22. the flow at reduced depth (1 mid UNet stage, 1 + 1 encoder blocks),
     card against CPU with the same weights, batch and draws, and a
     float64 CPU run: phase 9's checks on every leaf, the UNet's to_q
     and to_k weights (reached only through K2's dq and dk) included;
     both runs' distances to the float64 run are printed;
 23. HiFT (the mel mode's vocoder) at the full width of
     configs/default.yaml, random weights with a voiced f0, on a 5 s mel,
     card vs CPU: each side's harmonic phase against a float64 cumsum,
     the decode of one shared source, the whole forward; its time per
     call (CUDA events) and audio seconds per second;
 24. mel mode at full width with phase 4's LM cut to PATH_LM_LAYERS
     layers: synthesize_fused and the
     unfused synthesize (total_s, rtf, HiFT's seconds, 560 K1 launches
     per flow call), a chunked StreamingSession (time to first chunk,
     seconds per hop with HiFT's full-prefix decode, K1 per path);
 25. mel-mode serving at full width (phase 24's pipeline): one
     BatchSynthesizer call of 4
     requests (560 K1 launches), then cli/synthesize.main --override
     model.output_type=mel writing a 24 kHz wav;
 26. phase 5's reduced depth in mel mode with phase 23's HiFT, card vs
     CPU with the same weights and noise: token ids identical, PCM within
     a limit derived from phase 23's gaps and the f0 both sides computed
     (mel_pcm_tol);
 27. random upstream-layout flow and hift state dicts through torch.save
     and cli/convert_checkpoint.main into a checkpoint directory: the
     pipeline loaded from it holds the converter's weights bit for bit
     and gives the token ids of one built from them in memory, and its
     PCM within PCM_TOL_LSB;
 28. phase 7's LM step with per-layer remat "dots" and "none"
     (torch.utils.checkpoint; K2 runs inside the recompute): 2 warm-up
     and 3 timed steps each (step_s, peak memory, a profiled step's busy
     time) beside phase 7's remat-off numbers (the same step); K2
     launches per step asserted per mode, 48 + 24 (the recompute launches
     each layer's forward again), K1 none; the first-step gradients of
     each remat mode within REMAT_GRAD_RTOL of a remat-off first step's,
     per leaf;
 29. DPO (train/gan_steps.make_dpo_step) at full width, PATH_LM_LAYERS
     layers: phase 7's initialiser (seed 0) at that depth as the policy,
     a jittered copy as the frozen reference, 8 chosen and 8 rejected plans (other speech
     lengths) padded to 512; 2 warm-up and 3 timed steps and a profiled
     one with remat off, then with "dots"; K2 launches per step
     asserted, 24 + 12 off and 36 + 12 with "dots" (four forwards, two
     under grad, recomputed), K1 none; over the first 5 steps the loss
     falls and the reward accuracy does not;
 30. DPO at 2 layers, card (remat off, then "dots") against the CPU with
     the same weights, reference and batch (4 of phase 29's 8 pairs): the
     first step's sequence log-probs and every step's rewards, then phase
     9's checks on the loss, the reward accuracy, every leaf's first-step
     gradient and the parameters after 2 steps;
 31. cli/train.main --model llm --dpo --ref_ckpt (phase 29's reference
     weights as a .npz) at full width, PATH_LM_LAYERS layers, for one
     epoch on phase 8's corpus with a <stem>_fsq_reject.npy beside every
     wav: the four dpo/* metrics in every row, K2's launches per step
     (phase 8 holds the resume); then the plain LM with --override
     model.lm.qwen.remat=true (policy "dots") for one epoch at the same
     depth, K2's launches per step.
 32. training over ranks (one process per rank): first world size 1
     through the distributed code on NCCL (while the gang's ranks start,
     before their first job), phase 7's first-step loss and every leaf's
     gradient within REMAT_GRAD_RTOL of the one-process step's; then two
     ranks (utils/gang.Gang: two cards over NCCL, or one card shared over
     gloo, named in the line) at tp = 2 and at dp = 2 (4 of the 8 plans a
     rank), the LM at PATH_LM_LAYERS of its 24 layers (full widths),
     each against rank 0's one-process step on the whole batch:
     phase 9's limits on loss, accuracy and grad norms over DIST_STEPS
     steps, every leaf's gathered first-step gradient and the parameters
     after the steps; K2 6 + 6 launches per step on each rank, on its
     heads or rows; the DPO step the same way at tp = 2 (PATH_LM_LAYERS
     layers, 4 of phase 29's pairs, 2 steps; phase 30's metrics; K2
     4 x 6 + 2 x 6 per step on each rank); each rank's step_s, peak
     memory and the share of a step in its collectives, timed on the
     host with the card synchronised around each (timed_collectives),
     what those syncs add to the step, and the LM's last step under the
     profiler (traced_collectives: the card's copies through the host
     and the trace's collective events); K2 at each rank's shapes,
     (8, 7, 512, 64) and (4, 14, 512, 64), against its plain version and
     timed beside SDPA and the bound;
 33. the same for the flow (phase 20's batch and draws, contrastive FM
     and immiscible noise on, each rank taking its rows of the global
     draws) at tp = 2 and dp = 2 over FLOW_DIST_STEPS steps, at phase
     22's per-leaf limit; K2 56 + 56 launches per step on each rank; K2
     at (8, 4, 512, 64) and (4, 8, 512, 64) as in phase 32;
 34. python -m minimax_speech_torch.cli.launch --nproc 2 with cli/train.py
     --model llm --tp 2 at full width (LAUNCH_LM_LAYERS layers) for one
     epoch of phase 8's corpus (static batches of 8 plans padded to
     512), then a second gang that
     resumes at the saved step and writes --export_npz, which the port
     loads; K2's launches per step per rank asserted.
 35. DAC-VAE GAN training (train/gan_steps.make_dac_steps) at the full
     width of configs/default.yaml against the default DACDiscriminator
     (random weights, seed 0, fp32, TF32 off, AdamW 1e-4, fixed draws) on
     the CLI's batch, 64 crops of 0.38 s: a warm-up and GAN_ITERS timed
     iterations (median step_s of the disc and gen halves, audio seconds
     per second, peak memory), one profiled iteration (busy time; the
     shares of convolutions, GEMMs and FFTs; the host's idle share); K1
     and K2 launched 0 times;
 36. the same for HiFT against the default CosyVoiceDiscriminator on 16
     crops of 1.02 s with their host mel and YIN pitch;
 37. one DAC and one HiFT iteration at reduced width (reduced_gan),
     card against CPU with the same weights, batch and draws: phase 9's
     checks on the metrics, every leaf's gradient and the parameters
     after the step; S3TokenizerV1 (default width) over a 70 s mel, its
     3 windows in one batch: codes identical or a tie (V1_TIE_RTOL),
     quantize_long's merged tokens likewise;
 38. the CLIs on a written corpus: train_dac and train_hift
     (--train_data --with_pitch) for 2 iterations at full width and
     their default batches, then a resume for a third (the DAC's with
     --export_npz, which the port loads); extract_fsq v2 (a 35 s file
     over two windows) and v1_25hz, extract_dac_latents with the export
     (latent_stats.json), extract_embedding, eval_dac on the export (its
     JSON printed); K1 and K2 launched 0 times;
 39. CAM++ x-vector conditioning: the default CAM++ (80-bin fbank,
     blocks 12-24-16, 192-d) with random weights written into a
     campplus.onnx by write_onnx and read by the port's reader; the
     kaldi fbank and the embedding card vs CPU over 3 prompts of 3-10 s;
     TTS(model_dir=...) with that campplus.onnx, the flow's speaker
     encoder off, at the default widths (the LM at PATH_LM_LAYERS
     layers): inference_zero_shot, K1 560 launches per utterance; the
     synthesis CLI with --tokenizer_path on a written .tiktoken (byte
     ranks and a few merges; the stdlib BPE where tiktoken and regex do
     not import);
 40. the codec file: cli/codec.py compress then decompress of 60 s of
     speech-like audio at the default DAC-VAE (5 s windows, 1 s
     overlap): the chunked mu against a full-signal encode, the PCM card
     vs CPU, audio seconds per second each way; K1 = K2 = 0;
 41. the audiotools transforms: build_transform with a chain that runs
     every AudioSignal method the transforms use on phase 35's batch (64
     x 9120 samples) card vs CPU with the same draws; cli/train_dac.py
     for 2 iterations with that chain at --augment_prob 0.5; K1 = K2 = 0.
 42. Matcha-TTS synthesis: cli/matcha.py --random_init --hidden 192
     --n_layers 6 (the published width, the default UNet and HiFi-GAN V1)
     over 3 texts, unbatched and --batched: 40 K1 launches per synthesis
     call (4 UNet blocks x 10 steps) and K2 0, RTF, the acoustic model's,
     HiFi-GAN's and the denoiser's seconds, peak memory; the first text's
     mel card vs CPU on the same weights and z (MEL_RTOL of its peak); K1
     at (3, 4, 1000, 64) and (1, 4, 1000, 64) with the calls' frame
     lengths against its plain version, timed beside SDPA and the bound;
 43. Matcha training: cli/train_matcha.py at MatchaConfig() on 8 written
     wav/txt pairs, 3 steps of batch 8, K2 4 + 4 per step and K1 0
     asserted; the first step's losses and every leaf's gradient card vs
     CPU on the same batch and draws (the MAS path identical); the
     step's time and MAS's beside it; K2 at (8, 4, mel bucket, 64)
     against its plain version and timed;
 44. the legacy CosyVoice1 flow at LegacyFlowConfig(): inference with a
     1 s prompt and 5 s of new tokens (K1 640 launches: 64 UNet blocks x
     10 CFG steps; timed), a 2-step call card vs CPU (MEL_RTOL of the
     peak); one loss backward (K2 64 + 64, the loss and every leaf's
     gradient card vs CPU); K1 at (2, 8, T, 64) and (2, 8, ceil(T/2), 64)
     and K2 at the loss's shape against their plain versions and timed;
     then the legacy LM at LegacyLMConfig(): a loss forward and backward
     on 4 plans, card vs CPU.
 45. flowae's DiTo at DiToConfig() (encoder 64 channels, strides 4, 4,
     4, z_dim 32), the DiT renderer (192 wide, 6 deep, 6 heads, patch
     16), then the 1-D consistency UNet (128/256/512, pe 320, t 1280):
     encode and an 18-step decode of 2 clips at 24 kHz (119,808 samples,
     the longest multiple of 1,024 in 5 s; 7,488 DiT tokens) without and
     with renderer CFG 2.0 (ms per render step, RTF, peak memory, a
     profiled render step); make_dito_step at B 4 on
     16,384-sample crops, bf16 off and on (step_s, peak); card vs CPU at
     4,096 samples: the loss, every leaf's gradient, a 3-step CFG decode;
 46. ZDMConfig() over the DiT DiTo's latents: make_zdm_step at B 4 on
     the crops, zdm_generate of phase 45's 2 clips with its 18-step
     decode;
     GLPToConfig() against the MSD: a generator and a discriminator step
     at B 4; card vs CPU at 4,096 samples (the prior's loss and
     gradients, GLPTo's losses, weight and gradients);
 47. the image track at 256 x 256, B 4: DiToImageConfig() (f8c4, the
     2-D UNet at 128/256/512) a train step and a 50-step decode;
     ImageZDMConfig(n_classes=10) a step and class-conditional generation
     with CFG 2.0; VQGANConfig() the generator step (LPIPS, the adaptive
     GAN weight) and the discriminator step; card vs CPU at 32 x 32;
 48. the four flowae CLIs at their default --device: train_flowae
     --synthetic dito then zdm --ae_params, dito_infer --ckpt (phase
     46's autoencoder) on a written wav, train_flowae_image --synthetic
     dito then zdm --class_cond, image_dito --sample; the files each
     writes. Phases 45-48 launch neither K1 nor K2 (flowae's attention is
     plain torch at head dim 32), asserted per phase.
 49. export: a checkpoint directory of configs/default.yaml at random
     weights (the LM at PATH_LM_LAYERS layers) written by
     params_io.save_params, registry.write_manifest and verify_model_dir
     on it, registry.load_model equal to the written weights, the
     hub_tools card; then cli/export.main in this process with
     --ckpt_dir, --buckets 64,128,256, --matcha and --serving (the
     generated length capped at EXPORT_TOKENS), then again without
     --serving: each stage's seconds per bucket, first call and second.
     K1 560 launches per flow
     bucket and 40 per Matcha bucket, 0 in the other stages, the serving
     paths' launches counted, K2 0; K1's library in build/kernels/.
 50. the Qwen2 text tokenizer: a seeded synthetic Qwen2 directory at
     Qwen2's size (write_qwen2_dir: 151,643 regular ids, <|endoftext|>,
     <|im_start|>, <|im_end|> at 151643-151645) read by QwenTokenizer
     with `regex` hidden (the stdlib splitter): load seconds, encode
     chars/s on ~2k characters each of English, Chinese and mixed text
     with special tokens, the ids of QWEN_GOLDEN_TEXTS against
     transformers' (QWEN_GOLDEN); then at the widths of
     configs/default.yaml (W8A8 LM in bf16 at PATH_LM_LAYERS layers)
     TTS(pipeline=..., tokenizer_path=dir) zero-shot and
     cli/synthesize.py --tokenizer_path dir in a subprocess: the LM's
     text ids above 256 and under 151,936, K1 560 launches per
     utterance, K2 0.
 51. the learn-and-speak path at the proof's geometry (configs/tiny.yaml
     with cli/overfit_pipeline.py's overrides: UNet and LM heads of 8).
     K1 and K2 at head dims 8 and 16 against their plain versions, fp32
     and bf16, every mask mode, forward and (K2) backward, at the limits
     of phases 3 and 6; then cli/overfit_pipeline.run on the card in a
     temporary workdir at OFIT_BUDGET (2 utterances, tens to hundreds of
     steps a stage), the counters set to 0 before it: each stage's
     seconds and K1 / K2 launches asserted (0 in extraction and the
     codec's training, 3 + 3 K2 a flow step, 2 + 2 a LM step, 30 K1 a
     flow call of the evaluation), each stage's logged loss lower at its
     end; the same model directory evaluated on the CPU with the card's
     flow draws, the deterministic metrics within OFIT_EVAL_TOL; the
     bf16 flow A/B (cli/eval_bf16_flow.py) on it; the LM stage again at
     --lm_hidden 64 (heads of 16) from the same corpus and weights; K1
     at the evaluation's shape and K2 at the flow's and both LMs'
     training shapes timed as in phases 3 and 6.

Phases 1-4, 6 and 7 run alone on the card: the kernels' times and the
main paths' launches in the kernels' record come from them. The other
phases then run in three streams at once (STREAMS: synthesis 5, 10-18,
39-44, 49, 50; LM training 8, 9, 28-34, 51; flow and GAN 19-27, 35-38,
45-48), this process and two workers, so their times include the
others' load on the card and the host; each worker's log is printed
whole when it ends. Kernel launches are counted per process. The phases
whose device memory peaks above ~15 GiB (28, 32-33, 35-36, 38, 47) take
a lock (`heavy`), so that no two of them share the card's 80 GB.

The line before the last holds the kernels' record (JSON: K1 and K2 at
head dim 64, then phase 51's entries at head dims 8 and 16); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GEN_TOKENS = 125          # 5 s of audio at 25 Hz
TEXT_LEN = 12
# serving (phases 15-17): the longest request generates SERVE_TOKENS; each
# request is (prompt seconds, text tokens), its length text/12 of that
SERVE_TOKENS = 100
SERVE_SPECS = [(2.0, 6), (2.5, 8), (3.0, 10), (3.5, 12), (2.2, 7), (2.8, 9)]
PROMPT_TEXT_LEN = 4
PROMPT_SECONDS = 3.0
TIMED_RUNS = 2
# the LM depth of the phases whose subject is the flow, HiFT, serving or
# a CLI's plumbing, not the LM's decode (11, 13, 15-17, 24, 25 and 50):
# full width, 6 of the
# 24 layers, since the host-bound decode costs about 64 ms a token per
# 24 layers
PATH_LM_LAYERS = 6
# phase 34's LM depth: the launcher's two gangs start, initialise, save,
# restore and export the model, whose text embedding (136 M parameters)
# is most of its bytes at 2 layers
LAUNCH_LM_LAYERS = 2
# K1's comparison tolerances, |err| <= atol + rtol * |plain|: fp32 is the
# same arithmetic in another summation order; bf16 outputs are both an
# fp32 result rounded to bf16, so they may differ by one bf16 ulp (rtol
# 2^-7), and atol only covers fp32 noise on elements near zero (typical
# |ref| is ~0.1), as K2's output limit
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
MODES = {"full": {}, "causal": {"causal": True}, "chunk50": {"chunk": 50},
         "chunk50_left2": {"chunk": 50, "left_chunks": 2}}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
# ("float32" on the SIMT pipes, "tf32" on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
# the kernels compute fp32 products in 3xTF32: 3 tensor-core products each
TF32_PRODUCTS = 3
# the kernels whose products must run on the tensor cores (phase 2)
MMA_KERNELS = ("attn_fwd", "splash_fwd", "splash_dkdv", "splash_dq")
# the PCM of the reduced-depth run may differ between the card and the CPU
# by float32 sums in other orders through LM, flow and codec
PCM_TOL_LSB = 16
# K2's comparison tolerances, |err| <= atol + rtol * |plain|, output and
# gradients. float32: the same math in other summation orders. bf16: both
# sides compute in fp32 on the same bf16 inputs and round the result, so
# two results that straddle a rounding point differ by one bf16 ulp, which
# rtol 2^-7 covers. The kernels take Delta = rowsum(dO * O) from the
# rounded output, as JAX's splash does, where autograd of the plain
# version uses the unrounded one: dq and dk are compared after that
# known shift (splash.rounded_delta_shift; up to ~1e-2, ~0 in fp32).
# atol only covers fp32 noise on elements near zero (typical |ref| is
# ~0.1 for the output and ~0.05-0.1 for the gradients)
K2_TOL = {"float32": ((1e-5, 1e-5), (1e-5, 1e-4)),
          "bfloat16": ((1e-5, 2.0 ** -7), (1e-4, 2.0 ** -7))}
K2_MODES = {"causal": (1, -1), "full": (0, -1), "chunk50": (50, -1),
            "chunk50_left2": (50, 2)}
# the LM training batch of phases 7 and 9
LM_BATCH, LM_TEXT, LM_PAD, LM_REF_FRAMES = 8, 40, 512, 224
TRAIN_LR = 1e-4
# phase 9, card against CPU, float32 through 2 layers in other summation
# orders: each leaf's first-step gradient within 1e-4 of its largest
# element; the metrics of 3 steps at lr 1e-4 to 1e-4 relative. Adam
# scales each update to ~lr whatever the gradient's size, so where the
# gradient lies within that limit of zero (sign and size not pinned) the
# update rests on rounding and the element is left out of the parameter
# check; every other weight within 5% of lr per update, and all but 0.1%
# of each leaf within 1% of lr
TRAIN_METRIC_RTOL = TRAIN_GRAD_RTOL = 1e-4
TRAIN_PARAM_TOL, TRAIN_PARAM_ATOL, TRAIN_PARAM_SHARE = 0.05, 1e-6, 1e-3
# phase 22 holds every leaf to TRAIN_GRAD_RTOL, card vs CPU, as phase 9.
# The UNet's to_q and to_k weights get their gradient only through K2's
# dq and dk, which take Delta = rowsum(dO * O) from the forward kernel's
# output; at random weights (near-uniform attention, keys sharing a large
# mean) that output's error moves them far more than its size. With O
# summed by the tensor cores over every key tile they lay 1.36-2.38e-4 of
# their largest from float64 over seeds 5-8 (the CPU's float32 within
# 2.06e-5); K2's forward now sums each key tile in a zeroed fragment
# (csrc/attention_mma.cuh, mma_acc), and phase 22 prints both runs'
# distances to a float64 run beside the check (H100 80GB HBM3, 700 W;
# python -m minimax_speech_torch.kernels.variants --flow-grads)
# phases 23-27, the mel output mode: HiFT's weights and voiced f0 from
# HIFT_SEED (phase 23, and phase 26's pipelines), phase 23's mel of
# HIFT_FRAMES frames (5 s); card vs CPU, HiFT's decode of one shared
# source: float32 sums in other orders (TF32 off) on audio within +-0.99,
# a third of an int16 LSB; the decode's largest waveform change over the
# largest source change, as tests/test_torch_hift.py holds it
HIFT_SEED, HIFT_FRAMES = 23, 250
HIFT_DECODE_TOL = 1e-5
DECODE_GAIN = 4.0
# phases 28-31, the rest of LM training. Remat repeats the same float32
# work in the backward (TF32 off), so the first-step gradients of each
# remat mode lie within REMAT_GRAD_RTOL of each leaf's largest element of
# the remat-off step's; they lay 1.05e-7 apart, in the 2-row
# llm_embedding (H100 80GB HBM3, 700 W), and phase 28 prints two
# remat-off runs' distance beside it. DPO at the JAX package's
# beta; the reference policy is the policy with every parameter moved by
# DPO_JITTER times its leaf's spread, so the rewards are not 0
REMAT_GRAD_RTOL = 1e-6
DPO_BETA, DPO_JITTER = 0.01, 0.01
# phase 30 runs 4 of phase 29's 8 pairs: the CPU's four forwards and two
# backwards per step set the phase's time
DPO_CROSS_BATCH = 4
# phases 32 and 33: steps of each two-rank run against one process. The
# LM's: a warm-up, a plain step, one with its collectives timed on the
# host and one under the profiler; the flow's: a warm-up and a timed one
DIST_STEPS, FLOW_DIST_STEPS = 4, 2
# the flow training batch of phases 19-22: utterances of 160-256 tokens,
# padded to 256 (T = 512 latent frames), ragged reference mels
FLOW_BATCH, FLOW_TOKENS, FLOW_REF_FRAMES = 8, (160, 256), 224


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(n_bytes: int, flops: int) -> dict:
    """The least time the card could take for work moving `n_bytes` and
    doing `flops` fp32-accurate FLOPs: on the tensor cores in 3xTF32
    (`bound_ms`), and on the fp32 SIMT pipes (`bound_fp32_simt_ms`, the
    bound of the earlier SIMT kernels)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    tc_ms = TF32_PRODUCTS * flops / PEAK_FLOPS["tf32"] * 1e3
    simt_ms = flops / PEAK_FLOPS["float32"] * 1e3
    return {"bound_ms": max(bytes_ms, tc_ms),
            "bound_by": "bytes" if bytes_ms >= tc_ms else "operations",
            "bound_fp32_simt_ms": max(bytes_ms, simt_ms),
            "bytes_ms": bytes_ms, "tc_ms": tc_ms, "simt_ms": simt_ms}


def build_phase(build) -> None:
    """Phase 2: build every source, print ptxas's registers, shared memory
    and spills, and count the tensor-core instructions (HMMA, or HGMMA) in
    the SASS of each kernel; fails on a spill or on an attention kernel
    without them."""

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    secs = build.build(sources)
    log(f"[build] {sources} by nvcc {' '.join(build.NVCC_FLAGS)} in "
        f"{secs:.1f} s")
    def short(fn: str) -> str:  # a mangled name as kernel<dtype, D>
        kernel = next((k for k in MMA_KERNELS if k in fn), fn)
        dim = re.search(r"Li(\d+)EE", fn)
        return (f"{kernel}<{'bf16' if 'bfloat16' in fn else 'fp32'}"
                f"{', ' + dim[1] if dim else ''}>")

    spills = []
    for src, text in build.BUILD_LOG.items():
        fn = spill = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                fn = entry[1]
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found:
                spill = line.strip()
                if int(found[1]) or int(found[2]):
                    spills.append(f"{short(fn)}: {spill}")
            if "registers" in line:
                log(f"[build] {src} {short(fn)}: "
                    f"{line.split(':', 1)[-1].strip()}; {spill}")
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    counts = {}
    for src in sources:
        sass = subprocess.run(
            [str(cuobjdump), "--dump-sass", str(build.library_path(src))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        for body in sass.split("Function : ")[1:]:
            counts[body.split()[0]] = len(re.findall(r"\bH(?:G)?MMA\b", body))
    missing = []
    for kernel in MMA_KERNELS:
        found = {n: c for n, c in counts.items() if kernel in n}
        for n, c in sorted(found.items()):
            log(f"[build] SASS {short(n)}: {c} tensor-core instructions "
                f"(HMMA/HGMMA)")
        if not found or min(found.values()) == 0:
            missing.append(kernel)
    if spills:
        raise AssertionError(f"ptxas spills registers: {spills}")
    if missing:
        raise AssertionError(f"kernels without tensor-core instructions: "
                             f"{missing} (SASS functions {counts})")


def prompts():
    """bench.py's inputs: 220 Hz prompt at 16 and 24 kHz, random text."""
    t16 = np.arange(int(16000 * PROMPT_SECONDS)) / 16000
    t24 = np.arange(int(24000 * PROMPT_SECONDS)) / 24000
    rng = np.random.default_rng(1986)
    text = rng.integers(0, 150000, TEXT_LEN)
    ptext = rng.integers(0, 150000, PROMPT_TEXT_LEN)
    return ((0.5 * np.sin(2 * np.pi * 220 * t16)).astype(np.float32),
            (0.5 * np.sin(2 * np.pi * 220 * t24)).astype(np.float32),
            text, ptext)


def lm_depth(lm_cfg, n_layers: int):
    """lm_cfg with n_layers Qwen2 layers (full width)."""
    return dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
        lm_cfg.qwen, n_layers=n_layers))


def shallow_lm(cfg):
    """cfg with its LM cut to PATH_LM_LAYERS layers (full width)."""
    return dataclasses.replace(cfg, lm=lm_depth(cfg.lm, PATH_LM_LAYERS))


def fixed_length(cfg, n_tokens: int):
    """min_len == max_len == n_tokens for TEXT_LEN text tokens."""
    return dataclasses.replace(
        cfg, max_speech_tokens=n_tokens,
        min_token_text_ratio=n_tokens / TEXT_LEN,
        max_token_text_ratio=n_tokens / TEXT_LEN)


def attn_calls_per_step(u) -> int:
    """UNet attention calls per pass of a UNet with config `u`."""
    stages = 2 * len(u.channels) + u.num_mid_blocks
    return stages * u.n_blocks


def k1_checks(main_shape, kv_main):
    """Phase 3: K1 against its plain version; returns the record of K1
    (timings at the main-path shape)."""
    import torch

    b, h, t, d = main_shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = k1_agreement([(main_shape, kv_main), ((b, h, 77, d), (77, 40))],
                            MODES, gen)
    rec = k1_timing(gen, main_shape, kv_main)
    return {"name": "flash_attention", "route": "cuda",
            "source": "minimax_speech_torch/csrc/flash_attention.cu",
            "replaces": "minimax_speech_tpu/kernels/flash_attention.py:114",
            "max_abs_err": main_err, **rec}


def k1_agreement(cases, modes, gen) -> float:
    """K1 against its plain version on random q, k, v for each (shape,
    kv_len) case, in each mask mode, fp32 and bf16, at TOL; fails on any
    disagreement. Returns the largest fp32 error of the first case's
    first mode."""
    import torch

    from minimax_speech_torch.kernels import flash_attention as fa

    main_err = None
    failed = []
    saved = fa.launches  # checks are not main-path launches
    for shape, kv in cases:
        lens = torch.tensor(kv, device="cuda", dtype=torch.int32)
        base = [torch.randn(shape, generator=gen, device="cuda")
                for _ in range(3)]
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v = (x.to(dtype) for x in base)
            atol, rtol = TOL[dname]
            for mname, kw in modes.items():
                out = fa.flash_attention(q, k, v, kv_len=lens, **kw)
                ref = fa.reference_attention(q, k, v, lens, **kw)
                torch.cuda.synchronize()
                err = need = 0.0
                refs = []
                for i, n in enumerate(kv):
                    o, r = out[i, :, :n].float(), ref[i, :, :n].float()
                    if not torch.isfinite(o).all():
                        raise AssertionError(f"K1 non-finite {shape} {mname}")
                    diff = (o - r).abs()
                    err = max(err, float(diff.max()))
                    # the least atol that passes at this rtol
                    need = max(need, float((diff - rtol * r.abs()).max()))
                    refs.append(r.abs().flatten())
                ok = need <= atol
                log(f"[k1] T={shape[2]} kv={list(kv)} {dname:8s} "
                    f"{mname:13s} max_abs_err={err:.3e} need_atol="
                    f"{max(need, 0.0):.1e} median|ref|="
                    f"{float(torch.cat(refs).median()):.1e} "
                    f"tol={atol:g}+{rtol:g}*|ref| {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{shape} {dname} {mname} err {err}")
                if main_err is None:
                    main_err = err
    fa.launches = saved
    if failed:
        raise AssertionError(f"K1 disagrees: {failed}")
    return main_err


def k1_timing(gen, shape, kv, chunk: int = 0) -> dict:
    """K1, its plain version and torch's SDPA with the same boolean mask
    at one shape, fp32, as CUDA-graph replays, and one eager wrapper call;
    the kernel's error against the plain version; the bound."""
    import torch
    import torch.nn.functional as F

    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.utils.device import graph_ms

    b, h, t, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    lens = torch.tensor(kv, device="cuda", dtype=torch.int32)
    mask = fa.visible_mask(t, lens, chunk=chunk, batch=b, device="cuda")
    before = fa.launches
    kernel = lambda: fa.flash_attention(q, k, v, kv_len=lens,  # noqa: E731
                                        chunk=chunk)
    ref = fa.reference_attention(q, k, v, lens, chunk)
    diff = (kernel() - ref).abs()
    err = float(diff.max())
    atol, rtol = TOL["float32"]
    need = max(0.0, float((diff - rtol * ref.abs()).max()))
    kernel_ms, call_ms = graph_ms(kernel), cuda_ms(kernel)
    fa.launches = before  # timing launches are not main-path launches
    plain_ms = graph_ms(lambda: fa.reference_attention(q, k, v, lens, chunk))
    sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    n_bytes = 4 * q.numel() * q.element_size() + lens.numel() * 4
    flops = 4 * d * int(mask.sum()) * h  # QK^T and PV over visible pairs
    bd = bounds(n_bytes, flops)
    log(f"[k1] shape {tuple(shape)} kv={list(kv)} chunk {chunk} fp32, "
        f"CUDA-graph replays: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms (kernel/sdpa "
        f"{kernel_ms / sdpa_ms:.3f}); one eager wrapper call {call_ms:.4f} "
        f"ms; max |kernel - plain| {err:.2e} (need_atol {need:.1e}, tol "
        f"{atol:g}+{rtol:g}*|ref|); bound {bd['bound_ms']:.4f} ms "
        f"({n_bytes} B -> {bd['bytes_ms']:.4f} ms; {flops} FLOP in 3xTF32 "
        f"-> {bd['tc_ms']:.4f} ms), fp32 SIMT bound "
        f"{bd['bound_fp32_simt_ms']:.4f} ms")
    if need > atol:
        raise AssertionError(f"K1 at {shape} chunk {chunk}: error {err}")
    return {"ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "bound_fp32_simt_ms": bd["bound_fp32_simt_ms"],
            "library_ms": sdpa_ms, "shape": list(shape), "kv_len": list(kv),
            "chunk": chunk, "max_abs_err_at_shape": err}


def main_path(pipe, inputs, runs: int, card: str, generator_device: str):
    """Phase 4 body: prompt processing, a warm-up synthesis, then `runs`
    counted and timed ones. Returns (K1 launches per utterance, the
    (B, T) and key lengths K1 saw)."""
    import torch

    from minimax_speech_torch.kernels import flash_attention as fa

    a16, a24, text, ptext = inputs
    cfg = pipe.cfg
    prompt_tokens = pipe.extract_prompt_tokens(a16)
    prompt_latent = pipe.extract_prompt_feat(a24)
    prompt_mel = pipe.extract_prompt_mel(a24)
    lm_spk, flow_emb = pipe.speaker_embedding(prompt_mel)
    lm_spk = lm_spk.to(next(pipe.lm.parameters()).dtype)
    log(f"[main] prompt tokens {prompt_tokens.shape}, prompt features "
        f"({cfg.output_type}) {prompt_latent.shape}, mel "
        f"{prompt_mel.shape}, lm_spk "
        f"{tuple(lm_spk.shape)} {lm_spk.dtype}, flow_emb "
        f"{tuple(flow_emb.shape)}")

    watch = K1Watch(pipe)

    def run(seed):
        gen = torch.Generator(device=generator_device).manual_seed(seed)
        return pipe.synthesize_fused(text, ptext, prompt_tokens,
                                     prompt_latent, lm_spk, flow_emb,
                                     generator=gen, return_timings=True)

    run(1)  # warm-up
    results, per_utt = [], []
    for i in range(runs):
        fa.launches = 0
        wav, tim = run(2 + i)
        per_utt.append(fa.launches)
        pcm = np.round(wav * 32767)
        n_expect = GEN_TOKENS * cfg.token_latent_ratio * 480
        if tim["tokens"] != GEN_TOKENS or len(wav) != n_expect \
                or not np.isfinite(wav).all() or np.abs(pcm).max() > 32767:
            raise AssertionError(f"main path output: tokens {tim['tokens']}, "
                                 f"samples {len(wav)}")
        results.append(tim)
    watch.close()
    seen = {"bt": watch.seen[-1][1], "kv": watch.seen[-1][2]}
    tot = statistics.median(r["total_s"] for r in results)
    lm = statistics.median(r["lm_s"] for r in results)
    aud = results[0]["audio_s"]
    log(f"[main] {card} | tokens {GEN_TOKENS} samples "
        f"{GEN_TOKENS * cfg.token_latent_ratio * 480} finite int16 | "
        f"median total_s {tot:.4f} (LM decode {lm:.4f}, flow + codec + "
        f"copy {tot - lm:.4f}) audio_s {aud:.2f} rtf {tot / aud:.5f} "
        f"(runs {[round(r['total_s'], 4) for r in results]}) | "
        f"K1 launches per utterance {per_utt}, K1 saw (B, T) {seen['bt']} "
        f"kv_len {seen['kv']}")
    return per_utt, seen


def w8a8_checks(q, card: str):
    """Phase 10: the LM's W8A8 projections on the card against the CPU,
    per projection shape at M=1 (decode) and M=128 (prefill): the int8
    product (models/qwen2.int8_mm, torch._int_mm on the card) equals the
    CPU's exact int32 matmul, and a whole QuantDense layer's output equals
    the CPU's bit for bit in float32 and bf16 on the same input (the
    same operations on the same values). Times, as CUDA-graph replays:
    the int8 product beside a bf16 torch.matmul of the same shape, and
    the bf16 QuantDense layer beside a bf16 nn.Linear."""
    import copy

    import torch

    from minimax_speech_torch.models import qwen2
    from minimax_speech_torch.utils.device import graph_ms

    c, i = q.hidden_size, q.intermediate_size
    hd, kvd = q.n_heads * q.head_dim, q.n_kv_heads * q.head_dim
    shapes = {"q_proj": (c, hd), "k_proj": (c, kvd), "v_proj": (c, kvd),
              "o_proj": (hd, c), "gate_proj": (c, i), "up_proj": (c, i),
              "down_proj": (i, c)}
    gen = torch.Generator().manual_seed(11)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int16).to(torch.int8)

    bad = []
    for name, (k, n) in shapes.items():
        layer = qwen2.QuantDense(k, n, bias=name in ("q_proj", "k_proj",
                                                     "v_proj"))
        with torch.no_grad():
            layer.kernel_q.copy_(int8(n, k))
            layer.scale.uniform_(0.5 / k, 2.0 / k, generator=gen)
            if layer.bias is not None:
                layer.bias.normal_(generator=gen)
        w, wd = layer.kernel_q, layer.kernel_q.cuda()
        wb = (w.float() / 127).to(torch.bfloat16).cuda()
        linear = torch.nn.Linear(k, n, bias=False).cuda().to(torch.bfloat16)
        for m in (1, 128):
            x = int8(m, k)
            xd = x.cuda()
            same = {"int32": torch.equal(qwen2.int8_mm(xd, wd).cpu(),
                                         qwen2.int8_mm(x, w))}
            xf = torch.randn(m, k, generator=gen) * 3.0
            on_dev = {}
            for dname, dtype in (("fp32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                on_cpu = copy.deepcopy(layer).to(dtype)
                on_dev[dname] = copy.deepcopy(layer).cuda().to(dtype)
                with torch.no_grad():
                    same[dname] = torch.equal(
                        on_dev[dname](xf.to(dtype).cuda()).cpu(),
                        on_cpu(xf.to(dtype)))
            bad += [f"{name} M={m} {k_}" for k_, ok in same.items() if not ok]
            xb = xf.to(torch.bfloat16).cuda()
            with torch.no_grad():
                t_int8 = graph_ms(lambda: qwen2.int8_mm(xd, wd))
                t_bf16 = graph_ms(lambda: torch.matmul(xb, wb.t()))
                t_layer = graph_ms(lambda: on_dev["bf16"](xb))
                t_linear = graph_ms(lambda: linear(xb))
            w_ms = {dt: (n * k * size + m * k * size + m * n * out) /
                    HBM_BYTES_PER_S * 1e3
                    for dt, size, out in (("int8", 1, 4), ("bf16", 2, 2))}
            log(f"[w8a8] {name} (K={k}, N={n}) M={m}: card == CPU, int32 "
                f"accumulator {same['int32']}, layer fp32 {same['fp32']} "
                f"bf16 {same['bf16']}; CUDA-graph replays: int8 product "
                f"{t_int8:.4f} ms (bytes bound {w_ms['int8']:.4f}), bf16 "
                f"matmul {t_bf16:.4f} ms (bytes bound {w_ms['bf16']:.4f}); "
                f"QuantDense layer {t_layer:.4f} ms, bf16 Linear "
                f"{t_linear:.4f} ms")
    if bad:
        raise AssertionError(f"W8A8 differs from the CPU: {bad}")
    log(f"[w8a8] {len(shapes)} shapes x 2 row counts: int32 accumulators "
        f"and layer outputs identical to the CPU's on {card}")


def reduced(cfg):
    """Phase 5's reduced depth: 2 LM layers, 1 mid UNet block, 1+1
    encoder blocks, every width as given."""
    return dataclasses.replace(
        cfg,
        lm=dataclasses.replace(cfg.lm, qwen=dataclasses.replace(
            cfg.lm.qwen, n_layers=2)),
        flow=dataclasses.replace(
            cfg.flow,
            unet=dataclasses.replace(cfg.flow.unet, num_mid_blocks=1),
            encoder=dataclasses.replace(cfg.flow.encoder, num_blocks=1,
                                        num_up_blocks=1)))


def float_lm(cfg):
    return dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, qwen=dataclasses.replace(cfg.lm.qwen, quantized=False)))


def reduced_pipes(full_cfg, inputs, device="cuda"):
    """The reduced-depth pipelines of phases 5 and 12, float32 with the
    float LM (the W8A8 LM has its own check, w8a8_cross_check), with the
    same weights on the CPU and on `device`, and their prompt: (cfg, cpu,
    dev, prompt tokens, prompt latent, lm_spk, flow_emb)."""
    from minimax_speech_torch.infer.pipeline import TTSPipeline

    cfg = float_lm(reduced(full_cfg))
    a16, a24, _, _ = inputs
    cpu = TTSPipeline.from_random(cfg, seed=5, device="cpu")
    dev = TTSPipeline(cfg, device=device)
    for name, m in dev.models().items():
        m.load_state_dict(cpu.models()[name].state_dict())
    lm_spk, flow_emb = cpu.speaker_embedding(cpu.extract_prompt_mel(a24))
    return (cfg, cpu, dev, cpu.extract_prompt_tokens(a16),
            cpu.extract_prompt_feat(a24), lm_spk, flow_emb)


def cross_check(pipes, inputs, device="cuda", hift_gaps=None):
    """Phase 5 (and 26 in mel mode): reduced depth, same weights and
    noise on `device` and on the CPU. In mel mode the PCM limit is
    mel_pcm_tol's, from phase 23's `hift_gaps` and the f0 each side's
    HiFT computed here."""
    import torch

    from minimax_speech_torch.infer.pipeline import decode_plan
    from minimax_speech_torch.models import llm as llm_mod

    cfg, cpu, gpu, prompt_tokens, prompt_latent, lm_spk, flow_emb = pipes
    _, _, text, ptext = inputs
    g_top, g_fb = llm_mod.decode_noise(
        cfg.lm, cfg.max_speech_tokens, 1, torch.Generator().manual_seed(9))
    f0 = {}

    def tokens(pipe, dev):
        src, tok, plen, min_len, max_len = decode_plan(cfg, text, ptext,
                                                       prompt_tokens)
        out, cnt = llm_mod.generate(
            pipe.lm, src, tok, plen, lm_spk.to(dev), min_len, max_len,
            max_steps=cfg.max_speech_tokens,
            gumbel_top=g_top, gumbel_fallback=g_fb, device=dev)
        return out.cpu().numpy()[0, : int(cnt[0])]

    def pcm(pipe, dev):
        hook = None if pipe.hift is None else \
            pipe.hift.f0_predictor.register_forward_hook(
                lambda m, a, out: f0.__setitem__(dev, out.float().cpu()))
        wav = pipe.synthesize_fused(text, ptext, prompt_tokens, prompt_latent,
                                    lm_spk.to(dev), flow_emb.to(dev),
                                    gumbel_top=g_top, gumbel_fallback=g_fb)
        if hook is not None:
            hook.remove()
        return np.round(wav * 32767).astype(np.int32)

    ids_gpu, ids_cpu = tokens(gpu, device), tokens(cpu, "cpu")
    pcm_gpu, pcm_cpu = pcm(gpu, device), pcm(cpu, "cpu")
    tol, how = PCM_TOL_LSB, "latent mode"
    if cfg.output_type == "mel":
        tol, how = mel_pcm_tol(cpu.hift, hift_gaps, f0[device], f0["cpu"])
    same_ids = ids_gpu.shape == ids_cpu.shape and (ids_gpu == ids_cpu).all()
    diff = int(np.abs(pcm_gpu - pcm_cpu).max()) if \
        pcm_gpu.shape == pcm_cpu.shape else None
    corr = float(np.corrcoef(pcm_gpu, pcm_cpu)[0, 1]) if diff is not None \
        else float("nan")
    log(f"[cross] reduced depth (2 LM layers, 1 mid UNet block, 1+1 "
        f"encoder blocks), {cfg.output_type} mode, float32, TF32 off: token "
        f"ids identical {bool(same_ids)} ({len(ids_gpu)} vs {len(ids_cpu)} "
        f"tokens); PCM max |diff| {diff} LSB (tol {tol}: {how}), corr "
        f"{corr:.6f}, peak {int(np.abs(pcm_cpu).max())}")
    if not same_ids:
        raise AssertionError("token ids differ between the card and the CPU")
    if diff is None or diff > tol:
        raise AssertionError(f"PCM differs by {diff} LSB")


def w8a8_cross_check(full_cfg, pipes, inputs, device="cuda"):
    """Phase 5, the W8A8 LM as bench.py builds it (random int8 kernels,
    unit scales) at reduced depth with float32 activations (bf16 would
    round the other summation orders of attention and norms into
    different tokens), the same weights on the card and on the CPU.
    First every QuantDense call of the CPU's whole decode (the prefill's
    rows, then one row per step) is replayed on the card on the same
    input, and each output must equal the CPU's bit for bit. Then both
    devices decode with the same noise and the token ids must be
    identical. Rounding each activation row to int8 can turn float32
    noise into a whole int8 step where an element sits at a rounding
    boundary; the replay tells such a case apart from a fault in the
    layer."""
    import torch

    from minimax_speech_torch.infer.pipeline import decode_plan
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.models import qwen2
    from minimax_speech_torch.utils import params_io

    cfg, _, _, prompt_tokens, _, lm_spk, _ = pipes
    _, _, text, ptext = inputs
    lm_cfg = reduced(full_cfg).lm
    cpu = params_io.init_params(llm_mod.SpeechLM(lm_cfg),
                                torch.Generator().manual_seed(5)).eval()
    dev = llm_mod.SpeechLM(lm_cfg).to(device).eval()
    dev.load_state_dict(cpu.state_dict())
    g_top, g_fb = llm_mod.decode_noise(
        lm_cfg, cfg.max_speech_tokens, 1, torch.Generator().manual_seed(9))
    src, tok, plen, min_len, max_len = decode_plan(cfg, text, ptext,
                                                   prompt_tokens)
    on_card = dict(dev.named_modules())
    replay = {"calls": 0, "rows": 0, "differ": []}

    def hook(name):
        def check(mod, args, out):
            got = on_card[name](args[0].to(device)).cpu()
            replay["calls"] += 1
            replay["rows"] += out.numel() // out.shape[-1]
            if not torch.equal(got, out):
                replay["differ"].append(f"{name} rows {out.shape[:-1]}")
        return check

    ids = {}
    for name, lm in (("cpu", cpu), ("card", dev)):
        d = "cpu" if name == "cpu" else device
        hooks = [m.register_forward_hook(hook(n))
                 for n, m in lm.named_modules()
                 if name == "cpu" and isinstance(m, qwen2.QuantDense)]
        out, cnt = llm_mod.generate(lm, src, tok, plen, lm_spk.to(d), min_len,
                                    max_len, max_steps=cfg.max_speech_tokens,
                                    gumbel_top=g_top, gumbel_fallback=g_fb,
                                    device=d)
        for h in hooks:
            h.remove()
        ids[name] = out.cpu().numpy()[0, : int(cnt[0])]
    differ = np.nonzero(ids["card"] != ids["cpu"])[0] \
        if ids["card"].shape == ids["cpu"].shape else [0]
    log(f"[cross] W8A8 LM (2 layers, random int8 kernels, float32 "
        f"activations): the CPU decode's {replay['calls']} QuantDense calls "
        f"({replay['rows']} rows) replayed on the card, bit-identical in "
        f"{replay['calls'] - len(replay['differ'])}; free decode, card vs "
        f"CPU, same weights and noise: {len(differ)} of {len(ids['cpu'])} "
        f"token ids differ, the first at step "
        f"{int(differ[0]) if len(differ) else None}")
    if replay["differ"] or not replay["calls"]:
        raise AssertionError(f"W8A8 layers differ on the card on the CPU "
                             f"decode's inputs: {replay['differ'][:5]}")
    if len(differ):
        raise AssertionError("W8A8 token ids differ between the card and "
                             "the CPU")


def _prompt(pipe, inputs):
    a16, a24, text, ptext = inputs
    lm_spk, flow_emb = pipe.speaker_embedding(pipe.extract_prompt_mel(a24))
    lm_spk = lm_spk.to(next(pipe.lm.parameters()).dtype)
    return (text, ptext, pipe.extract_prompt_tokens(a16),
            pipe.extract_prompt_feat(a24), lm_spk, flow_emb)


def stream_main_path(pipe, inputs, card: str, device="cuda"):
    """Phase 11: the synthesis paths of the CLI at full width, each with
    K1's count set to 0 just before it and read just after: one unfused
    `synthesize`; a chunked StreamingSession (timed; the unfused call
    before it is the warm-up); a non-chunked one. Returns (K1 launches by
    path, the shapes K1 saw on the streaming paths)."""
    import torch

    from minimax_speech_torch.infer.session import StreamingSession
    from minimax_speech_torch.kernels import flash_attention as fa

    cfg = pipe.cfg
    args = _prompt(pipe, inputs)
    spf = 480
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    # K1's launches and the host seconds of each flow call, to its end on
    # the device
    watch = K1Watch(pipe)
    counts, secs, seen = watch.per_call, watch.secs, watch.seen
    on = device == "cuda"

    fa.launches = 0
    gen = torch.Generator(device=device).manual_seed(3)
    wav, tim = pipe.synthesize(*args, generator=gen, return_timings=True)
    counts["unfused"] = [fa.launches]
    log(f"[stream] {card} | unfused synthesize: tokens {tim['tokens']}, "
        f"audio_s {tim['audio_s']:.2f}, total_s {tim['total_s']:.4f} (LM "
        f"{tim['lm_s']:.4f}), K1 launches {fa.launches}, finite "
        f"{bool(np.isfinite(wav).all())}")
    if tim["tokens"] != GEN_TOKENS or not np.isfinite(wav).all() \
            or (on and counts["unfused"] != [expect]):
        raise AssertionError(f"unfused synthesize: {tim}, K1 {counts}")

    results = {}
    for chunked in (True, False):
        sess = StreamingSession(pipe, chunked=chunked)
        label = "chunked" if chunked else "nonchunked"
        if chunked:
            for name in ("prefill", "step", "final"):
                watch.count(sess.cfs, name, f"{label}_{name}", device)
        else:
            watch.count(sess, "_flow_chunk", f"{label}_hop", device)
        for key in [k for k in counts if k.startswith(label)]:
            counts[key], secs[key] = [], []
        seen.clear()
        fa.launches = 0
        gen = torch.Generator(device=device).manual_seed(4)
        t0 = time.perf_counter()
        stamps, chunks = [], []
        for chunk in sess.synthesize_stream(*args, generator=gen):
            stamps.append(time.perf_counter() - t0)
            chunks.append(chunk)
        total = np.concatenate([c.audio for c in chunks])
        results[label] = dict(ttfc=stamps[0], total=stamps[-1],
                              n=len(chunks), audio_s=len(total) / 24000,
                              tokens=chunks[-1].tokens,
                              launches=fa.launches, shapes=list(seen))
        # int16 PCM / 32767, crossfaded by Hamming halves (gain <= 1.08)
        ok = (chunks[-1].final and np.isfinite(total).all()
              and chunks[-1].tokens == GEN_TOKENS
              and np.abs(total).max() <= 1.1)
        if chunked:
            ok &= len(total) == 2 * GEN_TOKENS * spf
        r = results[label]
        log(f"[stream] {card} | {label}: time to first chunk "
            f"{r['ttfc']:.4f} s, total {r['total']:.4f} s, {r['n']} chunks, "
            f"audio_s {r['audio_s']:.2f}, rtf {r['total'] / r['audio_s']:.5f}"
            f", tokens {r['tokens']}, finite {bool(np.isfinite(total).all())}"
            f", peak {np.abs(total).max():.4f}; K1 launches "
            f"{ {k: v for k, v in counts.items() if k.startswith(label)} }"
            f"; flow s per call "
            f"{ {k: v for k, v in secs.items() if k.startswith(label)} }")
        if not ok:
            raise AssertionError(f"{label} streaming output: {r}")
    watch.close()

    modes = {m for m, _, _ in results["nonchunked"]["shapes"]}
    c50 = f"k1 chunk {cfg.flow.unet.static_chunk_size}"
    chunked_modes = {m for m, _, _ in results["chunked"]["shapes"]}
    log(f"[stream] K1 modes seen: chunked {sorted(chunked_modes)}, "
        f"non-chunked {sorted(modes)}")
    if on:
        hops = counts["nonchunked_hop"]
        want = dict(chunked_prefill=[expect],
                    chunked_step=[0] * len(counts["chunked_step"]),
                    chunked_final=[0], nonchunked_hop=[expect] * len(hops))
        got = {k: counts[k] for k in want}
        if got != want or c50 not in modes or len(hops) < 2:
            raise AssertionError(f"K1 launches on the streaming paths {got}, "
                                 f"expected {want}; modes {modes}")
    prefill = next(s for s in results["chunked"]["shapes"]
                   if s[0].startswith("k1"))
    hop = max((s for s in results["nonchunked"]["shapes"] if s[0] == c50),
              key=lambda s: s[1][1])
    launches = {"unfused": counts["unfused"][0],
                "stream_prefill": counts["chunked_prefill"][0],
                "stream_per_hop_chunked": counts["chunked_step"],
                "stream_per_hop_chunk50": counts["nonchunked_hop"][:-1],
                "stream_final_nonchunked": counts["nonchunked_hop"][-1]}
    return launches, {"prefill": (prefill[1], prefill[2]),
                      "chunk50_hop": (hop[1], hop[2])}, results


def stream_cross_check(pipes, inputs, device="cuda"):
    """Phase 12, reduced depth: the card's chunked session against its own
    unit-grid pass (flow_inference_unit_grid), and the streamed PCM of
    the card against the CPU's with the same weights and noise."""
    import torch

    from minimax_speech_torch.infer.session import StreamingSession
    from minimax_speech_torch.infer.stream_flow import ChunkedFlowSession
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.models.flow import flow_inference_unit_grid

    cfg, cpu, gpu, prompt_tokens, prompt_latent, lm_spk, flow_emb = pipes
    _, _, text, ptext = inputs
    hop, look, window = 25, 3, 100
    ratio = cfg.token_latent_ratio
    plen = min(len(prompt_tokens), prompt_latent.shape[0] // ratio)
    ptoks, pfeat = prompt_tokens[:plen], prompt_latent[: ratio * plen]
    gen_toks = np.random.default_rng(12).integers(0, 6561, GEN_TOKENS)
    emb = flow_emb.to(device)
    s = ChunkedFlowSession(gpu.flow, gpu.noise, token_hop=hop,
                           lookahead=look, max_tokens=512 + GEN_TOKENS + 64,
                           window=window, device=device)
    s.prefill(ptoks, pfeat, emb, gen_toks[:look])
    parts, c = [], 0
    while c + hop + look <= GEN_TOKENS:
        parts.append(s.step(gen_toks[c: c + hop],
                            gen_toks[c + hop: c + hop + look]))
        c += hop
    parts.append(s.final(gen_toks[c:]))
    chunked = np.concatenate(parts)
    tokens = np.concatenate([ptoks, gen_toks])[None]
    full = flow_inference_unit_grid(
        gpu.flow, tokens, [tokens.shape[1]], pfeat[None], plen, emb,
        gpu.noise, window=window, device=device)[0, ratio * plen:]
    full = full.float().cpu().numpy()
    atol, rtol = 5e-4, 1e-2
    diff = np.abs(chunked - full)
    need = max(0.0, float((diff - rtol * np.abs(full)).max()))
    log(f"[cross-stream] chunked session ({len(parts)} calls after the "
        f"prefill) vs the unit-grid pass on the card: frames "
        f"{chunked.shape} vs {full.shape}, max |diff| {diff.max():.2e}, "
        f"need_atol {need:.1e} (tol {atol:g}+{rtol:g}*|ref|), median |ref| "
        f"{np.median(np.abs(full)):.2e}")
    if chunked.shape != full.shape or need > atol:
        raise AssertionError("the chunked session differs from its unit grid")

    g_top, g_fb = llm_mod.decode_noise(
        cfg.lm, cfg.max_speech_tokens, 1, torch.Generator().manual_seed(13))

    def streamed(pipe, dev):
        sess = StreamingSession(pipe)
        chunks = list(sess.synthesize_stream(
            text, ptext, prompt_tokens, prompt_latent, lm_spk.to(dev),
            flow_emb.to(dev), gumbel_top=g_top, gumbel_fallback=g_fb))
        pcm = np.round(np.concatenate([c.audio for c in chunks]) * 32767)
        return pcm.astype(np.int32), len(chunks), chunks[-1].tokens

    pcm_gpu, n_gpu, tok_gpu = streamed(gpu, device)
    pcm_cpu, n_cpu, tok_cpu = streamed(cpu, "cpu")
    diff = int(np.abs(pcm_gpu - pcm_cpu).max()) if \
        pcm_gpu.shape == pcm_cpu.shape else None
    log(f"[cross-stream] streamed PCM, card vs CPU: {n_gpu} vs {n_cpu} "
        f"chunks, {tok_gpu} vs {tok_cpu} tokens, max |diff| {diff} LSB (tol "
        f"{PCM_TOL_LSB}), peak {int(np.abs(pcm_cpu).max())}")
    if tok_gpu != tok_cpu or diff is None or diff > PCM_TOL_LSB:
        raise AssertionError(f"streamed PCM differs: {diff} LSB")


def synth_cli_phase(config: str = "configs/default.yaml", device="cuda",
                    streams=(False, True), extra=(), tokenizer=None):
    """Phase 13 (and 25 in mel mode, with `extra` overrides; 39 with a
    .tiktoken `tokenizer`): cli/synthesize.main at full width with the
    W8A8 LM (PATH_LM_LAYERS deep), unfused and streaming as `streams`
    says, each writing a 24 kHz wav."""
    import tempfile
    import wave

    from minimax_speech_torch.cli import synthesize as synth_cli

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="synth_cli_",
                                     dir=scratch) as root:
        for stream in streams:
            out = Path(root) / f"out_{int(stream)}.wav"
            argv = ["--random_init", "--config", str(repo / config),
                    "--device", device, "--out", str(out),
                    "--text", "Hello there, this is a test.",
                    "--override", "model.lm.qwen.quantized=true",
                    "--override", "model.max_speech_tokens=100",
                    "--override", f"model.lm.qwen.n_layers={PATH_LM_LAYERS}",
                    *sum((["--override", o] for o in extra), []),
                    *(["--tokenizer_path", tokenizer] if tokenizer else [])]
            t0 = time.perf_counter()
            audio = synth_cli.main(argv + (["--stream"] if stream else []))
            secs = time.perf_counter() - t0
            with wave.open(str(out)) as w:
                n, rate = w.getnframes(), w.getframerate()
            log(f"[synth-cli] {'--stream' if stream else 'unfused'} "
                f"{list(extra)}{' --tokenizer_path' if tokenizer else ''}: "
                f"wrote {n} samples ({n / 24000:.2f} s) at "
                f"{rate} Hz in {secs:.1f} s")
            if n != len(audio) or n == 0 or not np.isfinite(audio).all() \
                    or rate != 24000:
                raise AssertionError(f"synthesis CLI wrote {n} samples")


def serving_k1_phase(batch_seen, hop_seen, h: int, d: int, chunk: int):
    """Phase 14: K1 at the serving shapes read off phases 15 and 16 (the
    batch call's full mode and the widest continuous hop's chunk mode,
    each B = 2 x requests for CFG, with their ragged key lengths), both
    modes at each, fp32 and bf16, against its plain version at phase 3's
    limits; then K1, plain and SDPA timed as graph replays in each path's
    own mode. Returns the records by path."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    modes = {"full": {}, "chunk50": {"chunk": chunk}}
    out = {}
    for path, ((b, t), kv), c in (("serve_batch_full", batch_seen, 0),
                                  ("serve_continuous_hop_chunk50", hop_seen,
                                   chunk)):
        k1_agreement([((b, h, t, d), kv)], modes, gen)
        out[path] = k1_timing(gen, (b, h, t, d), kv, c)
    return out


def serve_requests(pipe, specs):
    """Serving requests at the pipeline's width, one per (prompt seconds,
    text tokens) spec: a tone prompt of that length (its own pitch), the
    prompt tokens, latents and speaker conditioning extracted by the
    pipeline, random text and prompt text ids from numpy seed 7."""
    from minimax_speech_torch.infer.serving import Request

    rng = np.random.default_rng(7)
    reqs = []
    for i, (secs, n_text) in enumerate(specs):
        f = 180.0 + 40.0 * i
        a16, a24 = (0.5 * np.sin(2 * np.pi * f * np.arange(int(sr * secs))
                                 / sr).astype(np.float32)
                    for sr in (16000, 24000))
        lm_spk, flow_emb = pipe.speaker_embedding(pipe.extract_prompt_mel(a24))
        vocab = pipe.cfg.lm.qwen.vocab_size
        reqs.append(Request(
            text_tokens=rng.integers(0, vocab, n_text),
            prompt_text_tokens=rng.integers(0, vocab, PROMPT_TEXT_LEN),
            prompt_speech_tokens=pipe.extract_prompt_tokens(a16),
            prompt_feat=pipe.extract_prompt_feat(a24),
            lm_spk=lm_spk.float().cpu().numpy()[0],
            flow_emb=flow_emb.float().cpu().numpy()[0]))
    return reqs


def expected_tokens(cfg, r) -> int:
    """The token count of a request under fixed_length: min == max."""
    n = len(r.text_tokens)
    return min(int(n * cfg.max_token_text_ratio), cfg.max_speech_tokens)


class K1Watch:
    """Until close(): the mode, (B, T) and key lengths of every UNet
    attention call, seen at the first UNet block; and, per call of each
    method wrapped by count(), K1's launches and the host seconds to the
    call's end on the device."""

    def __init__(self, pipe):
        self.seen, self.per_call, self.secs = [], {}, {}

        def saw(mod, a):
            attn = a[1]
            mode = "plain" if attn.bias is not None else \
                f"k1 chunk {attn.chunk}"
            kv = None if attn.kv_len is None else attn.kv_len.tolist()
            self.seen.append((mode, tuple(a[0].shape[:2]), kv))
        self.hook = pipe.flow.estimator.down[0][1][0] \
            .register_forward_pre_hook(saw)

    def close(self):
        self.hook.remove()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def count(self, obj, name: str, label: str, device: str):
        """Wrap obj.name so each call appends to per_call[label] and
        secs[label]."""
        import torch

        from minimax_speech_torch.kernels import flash_attention as fa
        fn = getattr(obj, name)

        def run(*a, **kw):
            before, t0 = fa.launches, time.perf_counter()
            out = fn(*a, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            self.per_call.setdefault(label, []).append(fa.launches - before)
            self.secs.setdefault(label, []).append(
                round(time.perf_counter() - t0, 4))
            return out
        setattr(obj, name, run)


def serve_batch_phase(pipe, reqs, card: str, device="cuda"):
    """Phase 15: BatchSynthesizer at full width, the ragged requests in
    one batch (padded to a power of two), then the last one alone; K1
    counted from 0 per batch call. Returns (K1 launches per call, the
    full-mode (B, T) and kv_len K1 saw in the batch call)."""
    import torch

    from minimax_speech_torch.infer.serving import BatchSynthesizer
    from minimax_speech_torch.kernels import flash_attention as fa

    cfg = pipe.cfg
    synth = BatchSynthesizer(pipe)
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    results, launches, shapes = {}, [], {}
    for label, batch in (("B=4", reqs), ("B=1", reqs[-1:])):
        gen = torch.Generator(device=device).manual_seed(15)
        with K1Watch(pipe) as watch:
            fa.launches = 0
            wavs, tim = synth.synthesize_batch(batch, generator=gen,
                                               return_timings=True)
            launches.append(fa.launches)
        shapes[label] = watch.seen[0]
        want = [expected_tokens(cfg, r) for r in batch]
        ok = tim["tokens"] == want and all(
            len(w) == n * 960 and np.isfinite(w).all()
            for w, n in zip(wavs, want))
        results[label] = tim
        log(f"[serve-batch] {card} | {label} (padded to {tim['batch']}): "
            f"tokens {tim['tokens']} (expected {want}), audio_s "
            f"{tim['audio_s']:.2f}, total_s {tim['total_s']:.4f} (lm_s "
            f"{tim['lm_s']:.4f}, flow + codec + copy "
            f"{tim['e2e_s'] - tim['lm_s']:.4f}), audio-s per wall-s "
            f"{tim['audio_s'] / tim['total_s']:.4f}; K1 launches "
            f"{launches[-1]}, K1 saw {watch.seen[0]}")
        if not ok or (device == "cuda" and launches[-1] != expect):
            raise AssertionError(f"batched synthesis {label}: {tim}, K1 "
                                 f"{launches[-1]} (expected {expect})")
    mode, bt, kv = shapes["B=4"]
    if device == "cuda" and (mode != "k1 chunk 0" or bt[0] != 8
                             or len(set(kv)) < 2):
        raise AssertionError(f"K1 in the batch call saw {shapes['B=4']}")
    gain = (results["B=4"]["audio_s"] / results["B=4"]["total_s"]) / (
        results["B=1"]["audio_s"] / results["B=1"]["total_s"])
    log(f"[serve-batch] audio-s per wall-s, B=4 over B=1: {gain:.3f}")
    return launches, (bt, kv)


def serve_stream_phase(pipe, reqs, card: str, device="cuda"):
    """Phase 16: a ContinuousBatcher of 4 slots driven by run() with 6
    staggered arrivals (simulated clock), then a lockstep
    BatchStreamingSession of 3; K1 counted per hop call. Returns (K1
    launches per hop by path, the chunk-50 (B, T) and kv_len of the
    widest continuous hop)."""
    import torch

    from minimax_speech_torch.infer.continuous import ContinuousBatcher
    from minimax_speech_torch.infer.stream_batch import BatchStreamingSession
    from minimax_speech_torch.kernels import flash_attention as fa

    cfg = pipe.cfg
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    c50 = f"k1 chunk {cfg.flow.unet.static_chunk_size}"
    arrivals = [0.0, 0.0, 0.0, 0.0, 2.0, 4.0]
    cb = ContinuousBatcher(
        pipe, slots=4, generator=torch.Generator(device=device).manual_seed(16))
    with K1Watch(pipe) as watch:
        watch.count(cb, "flow_audio", "continuous", device)
        fa.launches = 0
        t0 = time.perf_counter()
        timed = list(cb.run(list(zip(arrivals, reqs))))
        wall = time.perf_counter() - t0
        cont_launches = fa.launches
    hops = watch.per_call["continuous"]
    ticks = cb._bursts
    finals = {e.stream: (t, e.tokens) for t, e in timed if e.final}
    audio = {}
    for t, e in timed:
        audio[e.stream] = audio.get(e.stream, 0) + len(e.audio)
    want = [expected_tokens(cfg, r) for r in reqs]
    lat = [round(finals[i][0] - arrivals[i], 3) if i in finals else None
           for i in range(len(reqs))]
    log(f"[serve-continuous] {card} | 4 slots, {len(reqs)} requests arriving "
        f"at {arrivals} s (simulated clock): latency to the final event "
        f"{lat} s, tokens {[finals.get(i, (0, None))[1] for i in range(len(reqs))]}"
        f" (expected {want}), {ticks} ticks, wall {wall:.2f} s; {len(hops)} "
        f"hop calls, K1 launches per hop {hops}; K1 modes "
        f"{sorted({m for m, _, _ in watch.seen})}, hop batches "
        f"{sorted({bt[0] for _, bt, _ in watch.seen})}")
    ok = (sorted(finals) == list(range(len(reqs)))
          and all(finals[i][1] == want[i] and audio[i] == want[i] * 960
                  for i in range(len(reqs)))
          and all(lane.free for lane in cb.lanes) and not cb.busy())
    if not ok:
        raise AssertionError(f"continuous batching: finals {finals}, audio "
                             f"{audio}, expected {want}")
    if device == "cuda" and (hops != [expect] * len(hops) or sum(hops)
                             != cont_launches
                             or {m for m, _, _ in watch.seen} != {c50}):
        raise AssertionError(f"K1 on the continuous hops: {hops}, modes "
                             f"{watch.seen[:3]}")
    widest = max((s for s in watch.seen), key=lambda s: (s[1][0], s[1][1]))

    sess = BatchStreamingSession(pipe)
    with K1Watch(pipe) as watch:
        watch.count(sess, "flow_audio", "lockstep", device)
        fa.launches = 0
        gen = torch.Generator(device=device).manual_seed(17)
        t0 = time.perf_counter()
        first, events = {}, []
        for ev in sess.run(reqs[:3], generator=gen):
            first.setdefault(ev.stream, time.perf_counter() - t0)
            events.append(ev)
        total = time.perf_counter() - t0
    lock_hops = watch.per_call["lockstep"]
    toks = {e.stream: e.tokens for e in events if e.final}
    log(f"[serve-lockstep] {card} | B=3: time to first chunk "
        f"{[round(first[i], 4) for i in range(3)]} s, total {total:.4f} s, "
        f"tokens {[toks.get(i) for i in range(3)]} (expected {want[:3]}); "
        f"{len(lock_hops)} hop calls, K1 launches per hop {lock_hops}")
    if [toks.get(i) for i in range(3)] != want[:3] or (
            device == "cuda" and lock_hops != [expect] * len(lock_hops)):
        raise AssertionError(f"lockstep streaming: tokens {toks}, K1 "
                             f"{lock_hops}")
    return ({"serve_continuous_hop": hops,
             "serve_stream_batch_hop": lock_hops},
            (widest[1], widest[2]))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_cli_phase(device="cuda", config="configs/default.yaml",
                    extra=("--override", "model.max_speech_tokens=30",
                           "--override", "model.lm.qwen.quantized=true",
                           "--override",
                           f"model.lm.qwen.n_layers={PATH_LM_LAYERS}")):
    """Phase 17: cli/serve.py as a subprocess on 127.0.0.1, once per
    scheduler, both started together: /healthz, a 3 s tone speaker
    registered, 3 concurrent /synthesize requests each answered with a
    24 kHz mono 16-bit WAV, a bad payload answered with 400."""
    import base64
    import io
    import urllib.error
    import urllib.request
    import wave
    from concurrent.futures import ThreadPoolExecutor

    repo = Path(__file__).resolve().parent
    tone = (0.5 * np.sin(2 * np.pi * 220 * np.arange(48000) / 16000))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((tone * 32767).astype(np.int16).tobytes())
    speaker = {"id": "tone", "prompt_text": "a tone",
               "wav_b64": base64.b64encode(buf.getvalue()).decode()}

    def post(url, payload):
        data = payload if isinstance(payload, bytes) else \
            json.dumps(payload).encode()
        req = urllib.request.Request(url, data=data, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    # both daemons start together: their start-ups (imports, random
    # weights on the host) overlap
    procs = {}
    try:
        for scheduler in ("window", "continuous"):
            port = free_port()
            cmd = [sys.executable, "-m", "minimax_speech_torch.cli.serve",
                   "--random_init", "--no_warm", "--config",
                   str(repo / config), "--device", device, "--port",
                   str(port), "--scheduler", scheduler, *extra]
            procs[scheduler] = (subprocess.Popen(
                cmd, cwd=repo, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True),
                f"http://127.0.0.1:{port}")
        t0 = time.perf_counter()
        for scheduler, (proc, base) in procs.items():
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"serve ({scheduler}) exited "
                                         f"{proc.returncode}: "
                                         f"{proc.stdout.read()[-3000:]}")
                try:
                    with urllib.request.urlopen(base + "/healthz",
                                                timeout=5) as r:
                        if r.status == 200 and r.read() == b"ok":
                            break
                except OSError:
                    pass
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"serve ({scheduler}) not up")
                time.sleep(0.5)
            up = time.perf_counter() - t0
            code, _ = post(base + "/register_speaker", speaker)
            if code != 200:
                raise AssertionError(f"register_speaker answered {code}")
            texts = ["Hello there, this is a test.", "A second request.",
                     "And a third one, somewhat longer than the others."]
            t1 = time.perf_counter()
            with ThreadPoolExecutor(3) as pool:
                answers = list(pool.map(lambda t: post(
                    base + "/synthesize", {"text": t, "speaker": "tone"}),
                    texts))
            secs = time.perf_counter() - t1
            frames = []
            for code, body in answers:
                if code != 200:
                    raise AssertionError(f"synthesize answered {code}: "
                                         f"{body[:200]!r}")
                with wave.open(io.BytesIO(body)) as w:
                    fmt = (w.getframerate(), w.getnchannels(),
                           w.getsampwidth())
                    frames.append(w.getnframes())
                if fmt != (24000, 1, 2) or frames[-1] == 0:
                    raise AssertionError(f"synthesize gave a {fmt} wav of "
                                         f"{frames[-1]} frames")
            bad = post(base + "/register_speaker",
                       {"id": "x", "wav_b64": "***"})[0], \
                post(base + "/synthesize", b"{not json")[0]
            if bad != (400, 400):
                raise AssertionError(f"bad payloads answered {bad}")
            log(f"[serve-cli] {scheduler}: up {up:.1f} s after both "
                f"started; 3 concurrent requests answered 200 in "
                f"{secs:.2f} s, 24 kHz mono int16 WAVs of {frames} samples; "
                f"bad payloads answered {bad}")
    finally:
        for proc, _ in procs.values():
            proc.terminate()
        for proc, _ in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def warm_phase(pipe, card: str, n_tokens: int = 20):
    """Phase 17, last: warm_serving once in-process on the full-width
    pipeline, its generated length cut to n_tokens."""
    from minimax_speech_torch.infer.api import TTS
    from minimax_speech_torch.infer.warmup import warm_serving

    pipe.cfg = fixed_length(pipe.cfg, n_tokens)
    tts = TTS(pipeline=pipe)
    tim = warm_serving(tts, scheduler="window", max_batch=4, verbose=False)
    log(f"[warmup] {card} | warm_serving (window, max_batch 4, "
        f"{n_tokens} tokens per utterance): "
        f"{ {k: round(v, 3) for k, v in tim.items()} }; speakers left "
        f"{tts.list_available_spks()}")
    if tts.list_available_spks():
        raise AssertionError("warm_serving left its speaker registered")


def serve_cross_check(pipes, device="cuda", n_tokens: int = 40):
    """Phase 18: reduced depth (float32 LM, 2 layers), the same weights
    and noise on `device` and on the CPU: BatchSynthesizer token ids and
    PCM, ContinuousBatcher bursts with a request joining mid-decode, and
    BistreamDecoder ids."""
    import torch

    from minimax_speech_torch.infer.bistream import BistreamDecoder
    from minimax_speech_torch.infer.continuous import ContinuousBatcher
    from minimax_speech_torch.infer.serving import BatchSynthesizer
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.ops import sampling as sampling_ops

    cfg, cpu, dev = pipes[:3]
    cfg = fixed_length(cfg, n_tokens)
    cpu.cfg = dev.cfg = cfg
    reqs = serve_requests(cpu, [(2.0, 6), (3.0, 9), (2.5, 12)])
    g_top, g_fb = llm_mod.decode_noise(cfg.lm, n_tokens, 4,
                                       torch.Generator().manual_seed(18))
    ids, pcm = {}, {}
    generate = llm_mod.generate
    for name, pipe in (("cpu", cpu), ("card", dev)):
        got = []

        def recorded(*a, **kw):
            out = generate(*a, **kw)
            got.append([row[row >= 0].tolist()
                        for row in out[0].cpu().numpy()])
            return out

        llm_mod.generate = recorded
        try:
            wavs = BatchSynthesizer(pipe).synthesize_batch(
                reqs, gumbel_top=g_top, gumbel_fallback=g_fb)
        finally:
            llm_mod.generate = generate
        ids[name] = got[0][:len(reqs)]
        pcm[name] = [np.round(w * 32767).astype(np.int32) for w in wavs]
    same = ids["cpu"] == ids["card"]
    diff = max(int(np.abs(a - b).max()) if a.shape == b.shape else 10 ** 9
               for a, b in zip(pcm["cpu"], pcm["card"]))
    log(f"[cross-serve] BatchSynthesizer, 3 requests padded to 4: token ids "
        f"identical {same} ({[len(x) for x in ids['card']]} tokens); PCM max "
        f"|diff| {diff} LSB (tol {PCM_TOL_LSB})")
    if not same or diff > PCM_TOL_LSB:
        raise AssertionError("batched synthesis differs card vs CPU")

    def noise(burst, first_step, n):  # the same tables on both devices
        return llm_mod.decode_noise(cfg.lm, n, 3,
                                    torch.Generator().manual_seed(100 + burst))

    bursts = {}
    for name, pipe in (("cpu", cpu), ("card", dev)):
        cb = ContinuousBatcher(pipe, slots=3, noise=noise)
        for r in reqs[:2]:
            cb.submit(r)
        rows = []
        for i in range(n_tokens // cb.token_hop + 2):
            if i == 1:
                cb.submit(reqs[2])  # joins at its own position
            cb._admit()
            rows.append(cb._burst(cb.token_hop)[0])
        bursts[name] = np.concatenate(rows, axis=1)
    same_c = np.array_equal(bursts["cpu"], bursts["card"])
    log(f"[cross-serve] ContinuousBatcher, 3 lanes, a request joining after "
        f"the first burst: token ids identical {same_c} "
        f"({int((bursts['card'] >= 0).sum())} tokens)")
    if not same_c:
        raise AssertionError("continuous batching differs card vs CPU")

    chunks = [np.random.default_rng(19).integers(0, cfg.lm.qwen.vocab_size, 4)
              for _ in range(6)]
    out = {}
    for name, pipe in (("cpu", cpu), ("card", dev)):
        def bnoise(burst, n):
            g = torch.Generator().manual_seed(200 + burst)
            return (sampling_ops.gumbel((n, cfg.lm.top_k), g),
                    sampling_ops.gumbel((n, cfg.lm.vocab), g))
        dec = BistreamDecoder(pipe.lm, max_steps=n_tokens,
                              device="cpu" if name == "cpu" else device)
        out[name] = list(dec.generate(
            iter(chunks), reqs[0].prompt_text_tokens,
            reqs[0].prompt_speech_tokens[:30],
            torch.as_tensor(reqs[0].lm_spk[None]), noise=bnoise))
    log(f"[cross-serve] BistreamDecoder: token ids identical "
        f"{out['cpu'] == out['card']} ({len(out['card'])} tokens)")
    if out["cpu"] != out["card"] or not out["cpu"]:
        raise AssertionError("bistream decoding differs card vs CPU")


def k2_checks(lm_shape, kv_lm):
    """Phase 6: K2 against its plain version, forward and the three
    gradients, in every mask mode; returns K2's record (times at the LM
    shape, fp32 causal)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    lm_err = k2_agreement([(lm_shape, kv_lm), ((2, 8, 77, lm_shape[3]),
                                               [77, 40])], K2_MODES, gen)
    rec = k2_timing(gen, lm_shape, kv_lm, "causal")
    return {"name": "splash_attention", "route": "cuda",
            "source": "minimax_speech_torch/csrc/splash_attention.cu",
            "replaces": "minimax_speech_tpu/kernels/splash.py:92",
            "max_abs_err": lm_err, **rec}


def k2_grads(q, k, v, do, lens, chunk, left, plain=False) -> list:
    """[out, dq, dk, dv] of K2's wrapper (or, with `plain`, its plain
    version) at its default scale s = 1/sqrt(d). dq is s times the
    gradient that reaches the scaled q (q * s in q's dtype), in float32:
    the kernels' dq, or the plain version's, before autograd of the
    scaling rounds it to q's dtype once more. Where s is a power of two
    (d = 16, 64) that rounding is exact and dq is autograd's dq; at d = 8
    it would add one rounding on each side. For the kernels, autograd's
    dq is also held to that gradient times s in q's dtype, bit for bit."""
    import torch

    from minimax_speech_torch.kernels import splash

    s = q.shape[-1] ** -0.5
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    if plain:
        # the plain version scales q as the wrapper does: take that scaled
        # q as the leaf, at scale 1
        x[0] = (q * s).to(q.dtype).requires_grad_()
        out = splash.reference_splash_attention(*x, lens, chunk, left,
                                                scale=1.0)
        dqs, dk, dv = torch.autograd.grad(out, x, do)
        return [out.detach(), dqs.float() * s, dk, dv]
    out = splash.splash_chunk_attention(*x, lens, chunk, left)
    caught = []
    # the node that scaled q; the gradient it receives is the kernels' dq
    out.grad_fn.next_functions[0][0].register_prehook(
        lambda g: caught.append(g[0]))
    dq, dk, dv = torch.autograd.grad(out, x, do)
    if not torch.equal(dq, (caught[0] * s).to(q.dtype)):
        raise AssertionError("K2's dq is not its scaled-q gradient times "
                             "the scale")
    return [out.detach(), caught[0].float() * s, dk, dv]


def k2_agreement(cases, modes, gen) -> float:
    """K2 against its plain version on random q, k, v, dO for each (shape,
    kv_len) case, in each mask mode of `modes` (name -> (chunk, left)),
    fp32 and bf16, output and dq, dk, dv at K2_TOL; fails on any
    disagreement. The wrapper runs at its default scale 1/sqrt(d); dq is
    compared as it reaches the wrapper's scaled q (k2_grads). Returns the
    largest fp32 error of the first case's first mode."""
    import torch

    from minimax_speech_torch.kernels import splash

    first_err = None

    failed = []
    for shape, kv in cases:
        lens = torch.tensor(kv, device="cuda", dtype=torch.int32)
        base = [torch.randn(shape, generator=gen, device="cuda")
                for _ in range(4)]
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v, do = (x.to(dtype) for x in base)
            for mname, (chunk, left) in modes.items():
                saved = dict(splash.launches)
                ours = k2_grads(q, k, v, do, lens, chunk, left)
                torch.cuda.synchronize()
                splash.launches.update(saved)  # checks are not the path
                ref = k2_grads(q, k, v, do, lens, chunk, left, plain=True)
                dq_shift, dk_shift = splash.rounded_delta_shift(
                    q, k, v, ours[0], do, lens, chunk, left)
                shifts = [0.0, dq_shift, dk_shift, 0.0]
                errs, parts, ok = [], [], True
                for i, (a, r) in enumerate(zip(ours, ref)):
                    a, r = a.float(), r.float()
                    atol, rtol = K2_TOL[dname][min(i, 1)]
                    if not torch.isfinite(a).all():
                        raise AssertionError(f"K2 non-finite {shape} {mname}")
                    diff = (a - r - shifts[i]).abs()
                    errs.append(float(diff.max()))
                    # the least atol that passes at this rtol, beside the
                    # typical |ref|, so the margin shows
                    need = max(0.0, float((diff - rtol * r.abs()).max()))
                    ok &= need <= atol
                    parts.append(f"{errs[-1]:.2e}/{need:.1e}/"
                                 f"{float(r.abs().median()):.1e}")
                log(f"[k2] {tuple(shape)} kv={list(kv)} {dname:8s} "
                    f"{mname:13s} out,dq,dk,dv max_err/need_atol/median|ref| "
                    f"{' '.join(parts)} (rounded-O Delta shift dq/dk max "
                    f"{float(dq_shift.abs().max()):.1e}/"
                    f"{float(dk_shift.abs().max()):.1e}) tol "
                    f"{K2_TOL[dname][0][0]:g}+"
                    f"{K2_TOL[dname][0][1]:g}*|ref| (grads "
                    f"{K2_TOL[dname][1][0]:g}+{K2_TOL[dname][1][1]:g}*|ref|) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{shape} {dname} {mname} errs {errs}")
                if first_err is None:
                    first_err = max(errs)
    if failed:
        raise AssertionError(f"K2 disagrees: {failed}")
    return first_err


def k2_timing(gen, shape, kv, mode: str) -> dict:
    """K2, its plain version and torch's SDPA with the same boolean mask
    at one shape and mask mode, fp32, forward and forward+backward, as
    CUDA-graph replays, and eager wrapper calls; the bounds."""
    import torch
    import torch.nn.functional as F

    from minimax_speech_torch.kernels import splash
    from minimax_speech_torch.utils.device import graph_ms

    b, h, t, d = shape
    chunk, left = K2_MODES[mode]
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    lens = torch.tensor(kv, device="cuda", dtype=torch.int32)
    mask = splash.visible_mask(t, lens, chunk, left)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def fwd(fn):
        return lambda: fn(q, k, v)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), do)

    kernel = lambda a, b_, c: splash.splash_chunk_attention(  # noqa: E731
        a, b_, c, lens, chunk, left)
    plain = lambda a, b_, c: splash.reference_splash_attention(  # noqa: E731
        a, b_, c, lens, chunk, left)
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b_, c, attn_mask=mask)
    # the kernels alone on q already scaled (the wrapper's scale is one
    # elementwise op), then whole calls with autograd, all as CUDA-graph
    # replays; the eager calls beside them show the wrappers' host time
    qs = (q / d ** 0.5).contiguous()
    saved = dict(splash.launches)
    out, lse = splash._kernel_forward(qs, k, v, lens, chunk, left)
    times = {"ms": graph_ms(lambda: splash._kernel_forward(
                 qs, k, v, lens, chunk, left)),
             "bwd_ms": graph_ms(lambda: splash._kernel_backward(
                 qs, k, v, lens, chunk, left, out, lse, do)),
             "fwd_bwd_ms": graph_ms(fwd_bwd(kernel)),
             "call_ms": cuda_ms(fwd(kernel)),
             "fwd_bwd_call_ms": cuda_ms(fwd_bwd(kernel))}
    splash.launches.update(saved)  # timing launches are not the path
    times.update(plain_ms=graph_ms(fwd(plain)),
                 plain_fwd_bwd_ms=graph_ms(fwd_bwd(plain)),
                 library_ms=graph_ms(fwd(sdpa)),
                 library_fwd_bwd_ms=graph_ms(fwd_bwd(sdpa)))
    pairs = int(mask.sum()) * h
    tensor_bytes = q.numel() * q.element_size()
    fwd_bytes = 4 * tensor_bytes + lens.numel() * 4
    bd = {}
    for name, n_bytes, flops in (("fwd", fwd_bytes, 2 * 2 * d * pairs),
                                 ("fwd_bwd", fwd_bytes + 4 * tensor_bytes,
                                  7 * 2 * d * pairs)):
        bd[name] = bounds(n_bytes, flops)
        log(f"[k2] bound {name}: {n_bytes} B -> {bd[name]['bytes_ms']:.4f} "
            f"ms; {flops} FLOP ({pairs} visible pairs) in 3xTF32 -> "
            f"{bd[name]['tc_ms']:.4f} ms, on the fp32 SIMT pipes -> "
            f"{bd[name]['simt_ms']:.4f} ms")
    log(f"[k2] shape {tuple(shape)} kv={list(kv)} fp32 {mode}, "
        f"CUDA-graph replays: kernel fwd {times['ms']:.4f} ms, bwd (dK/dV, "
        f"dQ and the Delta op) {times['bwd_ms']:.4f} ms, fwd+bwd through "
        f"autograd {times['fwd_bwd_ms']:.4f} ms (eager calls "
        f"{times['call_ms']:.4f} / {times['fwd_bwd_call_ms']:.4f} ms); "
        f"plain fwd "
        f"{times['plain_ms']:.4f} ms, fwd+bwd {times['plain_fwd_bwd_ms']:.4f}"
        f" ms; sdpa fwd {times['library_ms']:.4f} ms, fwd+bwd "
        f"{times['library_fwd_bwd_ms']:.4f} ms; bound fwd "
        f"{bd['fwd']['bound_ms']:.4f} ms, fwd+bwd "
        f"{bd['fwd_bwd']['bound_ms']:.4f} ms (fp32 SIMT bound "
        f"{bd['fwd']['bound_fp32_simt_ms']:.4f} / "
        f"{bd['fwd_bwd']['bound_fp32_simt_ms']:.4f} ms)")
    return {**times, "bound_ms": bd["fwd"]["bound_ms"],
            "bound_by": bd["fwd"]["bound_by"],
            "bound_fp32_simt_ms": bd["fwd"]["bound_fp32_simt_ms"],
            "fwd_bwd_bound_ms": bd["fwd_bwd"]["bound_ms"],
            "fwd_bwd_bound_by": bd["fwd_bwd"]["bound_by"],
            "fwd_bwd_bound_fp32_simt_ms":
                bd["fwd_bwd"]["bound_fp32_simt_ms"],
            "shape": list(shape), "kv_len": list(kv), "mode": mode}


def lm_plan(lm_cfg, texts, speech, pad_to: int = LM_PAD) -> dict:
    """Unistream plans of `texts` and `speech` token lists, padded."""
    from minimax_speech_torch.models import llm as llm_mod

    return llm_mod.build_lm_plan(
        texts, speech, mix_ratio=lm_cfg.mix_ratio, pad_to=pad_to,
        eos=lm_cfg.eos_token, fill=lm_cfg.fill_token)


def lm_batch(lm_cfg, batch: int = LM_BATCH, pad_to: int = LM_PAD,
             texts_out=None):
    """The fixed LM training batch: unistream plans of LM_TEXT text tokens
    and 250-460 speech tokens, padded to `pad_to`, and ragged reference
    mels, from numpy seed 0. The text token lists are appended to
    `texts_out` when given."""
    rng = np.random.default_rng(0)
    n_speech = rng.integers(250, 461, batch)
    texts = [rng.integers(1, lm_cfg.qwen.vocab_size, LM_TEXT)
             for _ in range(batch)]
    plan = lm_plan(lm_cfg, texts, [rng.integers(
        0, lm_cfg.speech_token_size, n) for n in n_speech], pad_to)
    if texts_out is not None:
        texts_out.extend(texts)
    mel_len = rng.integers(100, LM_REF_FRAMES + 1, batch).astype(np.int32)
    ref = np.zeros((batch, LM_REF_FRAMES, lm_cfg.speaker.mel_dim),
                   np.float32)
    for i, n in enumerate(mel_len):
        ref[i, :n] = rng.standard_normal((n, lm_cfg.speaker.mel_dim))
    return {**plan, "reference_mel": ref, "reference_mel_len": mel_len}


def _on(batch, device):
    import torch
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _train_state(module, device, seed=0):
    """`module` initialised from `seed` on `device`, and its train state
    (AdamW at TRAIN_LR, no warm-up)."""
    import torch

    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.utils import params_io

    model = params_io.init_params(module, torch.Generator().manual_seed(seed))
    model.to(device)
    tx = schedule.make_optimizer(lr=TRAIN_LR, warmup_steps=0)
    return model, steps.make_train_state(model, tx)


def profile_step(run_step, what: str = "one train step") -> dict:
    """`what` under torch.profiler: device busy time against the host's
    wall time, the shares of K2, GEMMs, convolutions and FFTs in the busy
    time,
    and the kernels that take the most. Returns those numbers, or {} when
    the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    if busy_ms == 0:
        log(f"[profile] {what}: the profiler saw no device time: not "
            f"measured")
        return {}

    def share(pick) -> float:
        return sum(us for name, us, _ in kernels if pick(name.lower())) / 1e3

    def is_conv(n: str) -> bool:  # cuDNN names its kernels by pass
        return any(w in n for w in ("conv", "fprop", "dgrad", "wgrad",
                                    "cudnn"))

    k2_ms = share(lambda n: "splash_" in n)
    conv_ms = share(is_conv)
    gemm_ms = share(lambda n: "gemm" in n and not is_conv(n))
    fft_ms = share(lambda n: "fft" in n)
    top = sorted(kernels, key=lambda x: -x[1])[:8]
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), K2 "
        f"kernels {k2_ms:.2f} ms ({k2_ms / busy_ms:.3f} of busy), GEMMs "
        f"{gemm_ms:.2f} ms ({gemm_ms / busy_ms:.3f}), convolutions "
        f"{conv_ms:.2f} ms ({conv_ms / busy_ms:.3f}), FFTs {fft_ms:.2f} ms "
        f"({fft_ms / busy_ms:.3f}), {len(kernels)} kernel names")
    for name, us, n in top:
        log(f"[profile]   {us / 1e3:8.2f} ms x{n:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "k2_ms": k2_ms,
            "gemm_ms": gemm_ms, "conv_ms": conv_ms, "fft_ms": fft_ms}


def train_main_path(model, state, make_step, args, final_loss, per_step,
                    work, what: str, card: str, device="cuda", timed=5,
                    more=()):
    """Phases 7 and 20: `model` trained from `state` on the fixed inputs
    `args` by make_step(**keywords)'s step: 2 warm-up steps, `timed`
    counted and timed ones, one profiled, more to 10 in all; then one
    step for each (label, keywords) of `more` and 2 bf16 steps, each
    counted. On the card every counted step must launch (K2's counts,
    K1's count) `per_step`; on the CPU none. final_loss(): the loss after
    the 10 steps, lower than the first step's. `work`: (amount, unit) of
    one step, for the rate. Returns the launch and time record."""
    import torch

    on_card = device == "cuda"
    expect = per_step if on_card else ({"forward": 0, "backward": 0}, 0)
    step = make_step()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []

    def one(fn=step):
        nonlocal state
        t0 = time.perf_counter()
        state, m = fn(state, *args)
        loss, gn = float(m["loss"]), float(m["grad_norm"])  # syncs
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"{what} train step {state.step}: loss "
                                 f"{loss}, grad_norm {gn}")
        losses.append(loss)
        return m

    def counted(fn, label):
        reset_counts()
        m = one(fn)
        seen = read_counts()
        if seen != expect:
            raise AssertionError(f"{what}, {label}: (K2, K1) launches "
                                 f"{seen}, expected {expect}")
        log(f"[train] {what}, {label}: loss {float(m['loss']):.4f}, "
            f"grad_norm {float(m['grad_norm']):.4f}, launches as expected")

    for _ in range(2):
        one()
    reset_counts()
    for _ in range(timed):
        one()
    k2, k1 = read_counts()
    per = {k: n / timed for k, n in k2.items()}
    prof = profile_step(one, f"one {what} train step") if on_card else {}
    while state.step < 10:
        one()
    with torch.no_grad():
        final = float(final_loss())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    step_s = statistics.median(secs[2: 2 + timed])
    amount, unit = work
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] {card} | {what} | {n_params} parameters in "
        f"{len(list(model.parameters()))} leaves | {unit} {amount} | median "
        f"step_s {step_s:.4f} (steps {[round(x, 4) for x in secs[2: 2 + timed]]}"
        f") | {unit}/s {amount / step_s:.1f} | peak memory "
        f"{peak / 2**30:.2f} GiB | K2 launches per step {per}, K1 "
        f"{k1 / timed} | loss {losses[0]:.4f} -> {final:.4f} after "
        f"{state.step} steps")
    if (k2, k1) != ({k: n * timed for k, n in expect[0].items()},
                    expect[1] * timed):
        raise AssertionError(f"{what}: {timed} steps launched K2 {k2} and "
                             f"K1 {k1}, expected {expect} per step")
    if not final < losses[0]:
        raise AssertionError(f"{what} loss did not fall: {losses[0]} -> "
                             f"{final}")
    for label, kw in more:
        counted(make_step(**kw), label)
    bf16_step = make_step(bf16=True)
    for i in range(2):
        counted(bf16_step, f"bf16 step {i + 1}")
    return {"launches": sum(k2.values()), "per_step": per,
            "step_s": step_s, "rate": amount / step_s, "profile": prof,
            "peak_gib": peak / 2**30}


def lm_train_phase(lm_cfg, batch, card: str, device="cuda"):
    """Phase 7: the LM on the fixed batch; each step launches K2 once
    forward and once backward per layer."""
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.train import steps

    model, state = _train_state(llm_mod.SpeechLM(lm_cfg), device)
    b = _on(batch, device)
    n = lm_cfg.qwen.n_layers
    rec = train_main_path(
        model, state, functools.partial(steps.make_lm_train_step, model,
                                        device=device),
        (b,), lambda: steps.make_lm_loss_fn(model)(b)[0],
        ({"forward": n, "backward": n}, 0),
        (int(batch["seq_len"].sum()), "plan tokens"),
        f"LM B={LM_BATCH} L={batch['src_type'].shape[1]}", card, device)
    return {"launches": rec["launches"], "launches_per_step": rec["per_step"],
            "step_s": rec["step_s"], "tokens_per_s": rec["rate"],
            "peak_gib": rec["peak_gib"],
            "busy_ms": rec["profile"].get("busy_ms")}


def write_corpus(root: Path, n: int = 16, seed: int = 0) -> Path:
    """n wavs of 8-16 s at 24 kHz with .txt, _fsq.npy and _latent2x.npy
    sidecars (tokens at 25 Hz, latents at 50 Hz); returns the list file."""
    import wave

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        sec = rng.uniform(8.0, 16.0)
        t = np.arange(int(sec * 24000)) / 24000
        audio = (0.5 * np.sin(2 * np.pi * 220.0 * t)
                 + 0.3 * np.sin(2 * np.pi * 880.0 * t)
                 + 0.05 * rng.standard_normal(t.shape))
        p = root / f"utt{i}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(24000)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype(
                np.int16).tobytes())
        (root / f"utt{i}.txt").write_text(f"synthetic utterance {i}")
        n_tok = len(audio) // 960
        np.save(root / f"utt{i}_fsq.npy",
                rng.integers(0, 6561, n_tok).astype(np.int32))
        np.save(root / f"utt{i}_latent2x.npy",
                rng.standard_normal((n_tok * 2, 80)).astype(np.float32))
        paths.append(str(p))
    lst = root / "data.list"
    lst.write_text("\n".join(paths))
    return lst


def write_rejects(lst: Path, seed: int = 2):
    """A <stem>_fsq_reject.npy beside every wav of the list: random tokens,
    up to 40 more or fewer than the chosen ones."""
    rng = np.random.default_rng(seed)
    for wav in lst.read_text().splitlines():
        stem = wav[:-len(".wav")]
        n = len(np.load(stem + "_fsq.npy")) + int(rng.integers(-40, 41))
        np.save(stem + "_fsq_reject.npy",
                rng.integers(0, 6561, n).astype(np.int32))


def cli_phase(config: str = "configs/default.yaml", device: str = "cuda",
              model: str = "llm", dpo: bool = False, remat: str = "off",
              resume: bool = True, lm_layers: int | None = None):
    """Phases 8, 21 and 31: cli/train.main at full width for one epoch on
    a synthetic corpus (a batch holds about 8 utterances), then a second
    call that resumes at the saved step. The flow run also takes a cv
    pass over the corpus, and on the card its train steps must launch
    only K2 in the UNet (per step one forward and one backward per
    transformer block) and its cv pass only K1 (one per block and
    batch). With `dpo` (phase 31) the corpus has reject sidecars and the
    run is --dpo against a --ref_ckpt of phase 29's reference weights
    (ref_checkpoint), its rows hold the four dpo/* metrics; `remat` other than
    "off" sets model.lm.qwen.remat and its policy. An LM run on the card
    other than phase 8's must launch K2 as k2_per_step says, K1 never.
    `resume` False skips the second call; `lm_layers` cuts the LM's depth
    (full widths)."""
    import shutil
    import tempfile

    from minimax_speech_torch.cli import train as train_cli

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_cli_", dir=scratch))
    try:
        lst = write_corpus(root)
        model_dir = root / "exp"
        # longest latent (16 s at 50 Hz = 800 frames) x 8 utterances
        argv = ["--model", model, "--config", str(repo / config),
                "--train_data", str(lst), "--model_dir", str(model_dir),
                "--device", device, "--max_epoch", "1",
                "--override", "train.max_frames_in_batch=6400",
                "--override", "train.save_per_step=2",
                "--override", "train.warmup_steps=0",
                "--override", "train.log_interval=1"]
        if remat != "off":
            argv += ["--override", "model.lm.qwen.remat=true",
                     "--override", f"model.lm.qwen.remat_policy={remat}"]
        if lm_layers:
            argv += ["--override", f"model.lm.qwen.n_layers={lm_layers}"]
        if dpo:
            write_rejects(lst)
            argv += ["--dpo", "--ref_ckpt", str(ref_checkpoint(
                repo / config, root / "ref.npz", lm_layers))]
        cv = ["--cv_data", str(lst)] if model == "flow" else []
        loss_key = "dpo/loss" if dpo else "loss"
        reset_counts()
        t0 = time.perf_counter()
        first = train_cli.main(argv + cv)
        t1 = time.perf_counter()
        k2, k1 = read_counts()
        rows = [json.loads(line) for line in (
            model_dir / f"{model}_metrics.jsonl").read_text().splitlines()]
        losses = [r[loss_key] for r in rows if loss_key in r]
        dpo_keys = {"dpo/loss", "dpo/chosen_reward", "dpo/rejected_reward",
                    "dpo/reward_acc"}
        if dpo and not all(dpo_keys <= r.keys() for r in rows
                           if loss_key in r):
            raise AssertionError(f"train CLI --dpo rows: {rows}")
        cv_losses = [r["cv/loss"] for r in rows if "cv/loss" in r]
        ckpts = sorted(p.name for p in (model_dir / "ckpt").iterdir())
        if not losses or not np.isfinite(losses + cv_losses).all() \
                or not ckpts or len(cv_losses) != bool(cv):
            raise AssertionError(f"train CLI: losses {losses}, cv "
                                 f"{cv_losses}, checkpoints {ckpts}")
        resumed = "no second call"
        if resume:
            second = train_cli.main(argv)
            if second.step != first.step or str(first.step) not in ckpts:
                raise AssertionError(f"train CLI resume: step "
                                     f"{second.step}, first run "
                                     f"{first.step}, ckpts {ckpts}")
            resumed = (f"second call resumed at step {second.step} in "
                       f"{time.perf_counter() - t1:.1f} s")
        log(f"[cli] --model {model}{' --dpo' * dpo} remat {remat}: one "
            f"epoch of {len(losses)} steps in "
            f"{t1 - t0:.1f} s, losses {[round(x, 4) for x in losses]}, cv "
            f"{[round(x, 4) for x in cv_losses]}, checkpoints {ckpts}, K2 "
            f"launches {k2}, K1 launches {k1}; {resumed}")
        if model == "flow" and device == "cuda":
            n = attn_calls_per_step(first.module.cfg.unet)
            if k2 != {"forward": n * first.step, "backward": n * first.step} \
                    or k1 == 0 or k1 % n:
                raise AssertionError(f"train CLI --model flow: K2 {k2}, K1 "
                                     f"{k1}, {first.step} steps, {n} "
                                     f"attention calls per UNet pass")
        if model == "llm" and (dpo or remat != "off") and device == "cuda":
            per, _ = k2_per_step(first.module.cfg, 4 if dpo else 1,
                                 2 if dpo else 1, remat)
            if (k2, k1) != ({k: n * first.step for k, n in per.items()}, 0):
                raise AssertionError(f"train CLI, dpo {dpo}, remat {remat}: "
                                     f"K2 {k2}, K1 {k1} in {first.step} "
                                     f"steps, expected {per} per step")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ref_checkpoint(config: Path, path: Path, lm_layers=None) -> Path:
    """Phase 29's reference policy (seed 0 jittered from seed 1) at the
    LM geometry of `config` (at lm_layers layers if given), written as a
    .npz in the JAX package's format: weights unlike the CLI's starting
    ones (seed 1986)."""
    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.utils import params_io

    lm_cfg = cfg_lib.load_tts_config(str(config)).lm
    lm = lm_module(lm_depth(lm_cfg, lm_layers) if lm_layers else lm_cfg,
                   "cpu", 0, 1)
    params_io.save_params(str(path), lm)
    return path


def first_grads(model, loss) -> dict:
    """{parameter name: gradient on the CPU} of `loss` at the current
    weights (zeros where a parameter gets none)."""
    import torch

    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
            for n, p, g in zip(names, params, grads)}


def train_cross_check(full_lm_cfg, batch, device="cuda", steps_n=2):
    """Phase 9: 2 LM layers, the same weights and batch on `device` and on
    the CPU: every leaf's gradient at the start, the metrics of each
    step, and the parameters after `steps_n` steps."""
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.train import steps

    cfg = dataclasses.replace(full_lm_cfg, qwen=dataclasses.replace(
        full_lm_cfg.qwen, n_layers=2))
    runs = {}
    for dev in ("cpu", device):
        model, state = _train_state(llm_mod.SpeechLM(cfg), dev, seed=5)
        b = _on(batch, dev)
        grads = first_grads(model, steps.make_lm_loss_fn(model)(b)[0])
        step = steps.make_lm_train_step(model, device=dev)
        metrics = []
        for _ in range(steps_n):
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[dev] = (metrics, grads, {n: p.detach().cpu() for n, p in
                                      model.named_parameters()})
        del model, state, b
    compare_training(runs, device, steps_n, "cross-train",
                     "2 layers")


def grad_errors(grads, ref, symmetric=()) -> dict:
    """{leaf: max |grads - ref| over the leaf's largest |ref|}, in ref's
    dtype; the `symmetric` leaves, whose ref is 0 but for rounding, over
    the model's largest |ref|."""
    top = max(float(g.abs().max()) for g in ref.values())
    return {n: float((grads[n].to(r.dtype) - r).abs().max()) / max(
        top if n in symmetric else float(r.abs().max()), 1e-30)
        for n, r in ref.items()}


def compare_training(runs, device, steps_n, tag, what, symmetric=(),
                     k2_leaves=(), truth=None, loss_key="loss"):
    """Phases 9, 22 and 37: the runs on `device` and on the CPU, {dev:
    (metrics per step, first-step gradients, parameters after steps_n
    steps)}, held to the TRAIN_* limits. `symmetric`: parameter names
    whose gradient is 0 by symmetry, so both sides hold rounding only:
    their first-step gradient is held to TRAIN_GRAD_RTOL of the model's
    largest gradient element instead of their own, and their parameters
    are left out as unpinned. `truth`: the first-step gradients of a
    float64 run on the CPU, against which both runs' distances are
    printed, those of `k2_leaves` (parameter names whose gradient reaches
    them only through K2's dq and dk) apart."""
    (m_dev, g_dev, p_dev), (m_cpu, g_cpu, p_cpu) = runs[device], runs["cpu"]
    worst = max(abs(a[k] - c[k]) / max(abs(c[k]), 1e-12)
                for a, c in zip(m_dev, m_cpu) for k in c)
    max_tol = TRAIN_PARAM_TOL * TRAIN_LR * steps_n
    grad_err = grad_errors(g_dev, g_cpu, symmetric)
    if truth is not None:  # (card, CPU) against float64
        to_truth = [grad_errors(g, truth, symmetric) for g in (g_dev, g_cpu)]
    bad, leaf_max, leaf_share = [], {}, {}
    n_out = n_moved_out = 0
    out_max = 0.0
    for n in p_cpu:
        # elements whose gradient the check above does not pin (within its
        # limit of zero): Adam's update there rests on rounding
        pinned = g_cpu[n].abs() >= TRAIN_GRAD_RTOL * float(
            g_cpu[n].abs().max())
        if n in symmetric:
            pinned[...] = False
        d = (p_dev[n] - p_cpu[n]).abs()
        if not pinned.all():
            n_out += int((~pinned).sum())
            n_moved_out += int(((~pinned) & (g_cpu[n] != 0)).sum())
            out_max = max(out_max, float(d[~pinned].max()))
        d = d[pinned]
        leaf_max[n] = float(d.max()) if d.numel() else 0.0
        leaf_share[n] = float((d > TRAIN_PARAM_ATOL).float().mean()) \
            if d.numel() else 0.0
        if grad_err[n] > TRAIN_GRAD_RTOL or leaf_max[n] > max_tol \
                or leaf_share[n] > TRAIN_PARAM_SHARE:
            bad.append(f"{n}: grad err {grad_err[n]:.2e} of its largest, "
                       f"param max {leaf_max[n]:.2e} share "
                       f"{leaf_share[n]:.2e}")
    worst_grad = max(grad_err, key=grad_err.get)
    worst_max = max(leaf_max, key=leaf_max.get)
    worst_share = max(leaf_share, key=leaf_share.get)
    log(f"[{tag}] {what}, {steps_n} steps, TF32 off: {loss_key} "
        f"{[round(m[loss_key], 5) for m in m_dev]} vs "
        f"{[round(m[loss_key], 5) for m in m_cpu]}; worst metric rel diff "
        f"{worst:.2e} (tol {TRAIN_METRIC_RTOL:g}); first-step gradient per "
        f"leaf: worst max |diff| {grad_err[worst_grad]:.2e} of the leaf's "
        f"largest ({worst_grad}; tol {TRAIN_GRAD_RTOL:g}; "
        f"{len(symmetric)} leaves zero by symmetry held to the model's "
        f"largest); params per "
        f"leaf: worst max |diff| {leaf_max[worst_max]:.2e} ({worst_max}; "
        f"tol {max_tol:g}), worst share above {TRAIN_PARAM_ATOL:g} "
        f"{leaf_share[worst_share]:.2e} ({worst_share}; tol "
        f"{TRAIN_PARAM_SHARE:g}); left out {n_out} elements with gradient "
        f"below {TRAIN_GRAD_RTOL:g} of their leaf's largest ({n_moved_out} "
        f"of them nonzero), max |diff| there {out_max:.2e}")
    if truth is not None:
        for side, errs in (("card", to_truth[0]), ("CPU float32",
                                                    to_truth[1])):
            w = sorted(errs, key=lambda n: -errs[n])[:3]
            log(f"[{tag}] first-step gradient, {side} against float64, of "
                f"the leaf's largest: worst "
                f"{', '.join(f'{errs[n]:.2e} ({n})' for n in w)}")
        if k2_leaves:
            w = max(k2_leaves, key=to_truth[0].get)
            log(f"[{tag}] the {len(k2_leaves)} leaves reached only through "
                f"K2's dq/dk: card against float64 worst "
                f"{to_truth[0][w]:.2e} ({w}), the CPU's float32 "
                f"{max(to_truth[1][n] for n in k2_leaves):.2e}; card against "
                f"the CPU {max(grad_err[n] for n in k2_leaves):.2e} (tol "
                f"{TRAIN_GRAD_RTOL:g})")
    for line in bad:
        log(f"[{tag}]   FAIL {line}")
    if worst > TRAIN_METRIC_RTOL or bad:
        raise AssertionError(f"training differs between the runs ({what})")


def flow_batch(flow_cfg, batch: int = FLOW_BATCH):
    """The fixed flow training batch: FLOW_BATCH utterances of
    FLOW_TOKENS tokens (the longest 256, so padding_flow's bucket gives
    T = 512 latent frames) with random latents and ragged reference mels,
    from numpy seed 0, through the port's padding_flow."""
    from minimax_speech_torch.data import pipeline as dp

    rng = np.random.default_rng(0)
    n_tok = rng.integers(FLOW_TOKENS[0], FLOW_TOKENS[1] + 1, batch)
    n_tok[0] = FLOW_TOKENS[1]
    mel_len = rng.integers(100, FLOW_REF_FRAMES + 1, batch)
    d = flow_cfg.output_size
    samples = [{"speech_token": rng.integers(0, flow_cfg.vocab_size, n),
                "speech_latent": rng.standard_normal((2 * n, d)).astype(
                    np.float32),
                "reference_mels": [rng.standard_normal(
                    (m, flow_cfg.speaker.mel_dim)).astype(np.float32)]}
               for n, m in zip(n_tok, mel_len)]
    return next(dp.padding_flow([samples]))


def _flow_draws(flow_cfg, batch, device, seed=0):
    """Draws for `batch` from a generator on the CPU, moved to `device`,
    so that the card and the CPU train on the same numbers."""
    import torch

    from minimax_speech_torch.models import flow as flow_mod

    d = flow_mod.make_flow_draws(flow_cfg, *batch["feat"].shape[:2],
                                 torch.Generator().manual_seed(seed))
    return flow_mod.FlowDraws(
        use_cond=d.use_cond.to(device), frac=d.frac.to(device),
        cfm=dataclasses.replace(d.cfm, **{
            f.name: getattr(d.cfm, f.name).to(device)
            for f in dataclasses.fields(d.cfm)
            if torch.is_tensor(getattr(d.cfm, f.name))}))


def reset_counts():
    """Set K1's and K2's launch counters to 0."""
    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.kernels import splash
    fa.launches = 0
    splash.launches.update(forward=0, backward=0)


def read_counts():
    """(K2's {forward, backward} launches, K1's launches)."""
    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.kernels import splash
    return dict(splash.launches), fa.launches


def flow_k2_phase(shape, kv):
    """Phase 19: K2 at the flow-training shape (B, 8, T, 64) with the
    phase-20 batch's key lengths, in the UNet's full and chunk-50 modes,
    fp32 and bf16, against its plain version at K2_TOL; then timed in
    each mode. Returns the records by mode."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(19)
    modes = {m: K2_MODES[m] for m in ("full", "chunk50")}
    k2_agreement([(shape, kv)], modes, gen)
    return {f"flow_train_{m}": k2_timing(gen, shape, kv, m) for m in modes}


def flow_train_phase(flow_cfg, batch, card: str, device="cuda"):
    """Phase 20: the flow on the fixed batch with fixed draws; each step
    (also a streaming=True one, in K2's chunk mode) launches K2 once
    forward and once backward per UNet transformer block, and K1 never."""
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.train import steps

    model, state = _train_state(flow_mod.FlowModel(flow_cfg), device)
    b = _on(batch, device)
    draws = _flow_draws(flow_cfg, batch, device)
    n = attn_calls_per_step(flow_cfg.unet)
    rec = train_main_path(
        model, state, functools.partial(steps.make_flow_train_step, model,
                                        device=device),
        (b, draws), lambda: steps.make_flow_loss_fn(model)(b, draws),
        ({"forward": n, "backward": n}, 0),
        (int(batch["feat_len"].sum()), "target frames"),
        f"flow B={batch['feat'].shape[0]} T={batch['feat'].shape[1]}", card,
        device, more=[(f"a streaming=True step (K2 chunk "
                       f"{flow_cfg.unet.static_chunk_size})",
                       {"streaming": True})])
    return {"flow_train": rec["launches"],
            "flow_train_per_step": rec["per_step"],
            "flow_step_s": rec["step_s"], "flow_frames_per_s": rec["rate"],
            "flow_profile": rec["profile"]}


def reduced_flow(flow_cfg):
    """1 mid UNet stage and 1 + 1 encoder blocks, widths as given."""
    return dataclasses.replace(
        flow_cfg,
        encoder=dataclasses.replace(flow_cfg.encoder, num_blocks=1,
                                    num_up_blocks=1),
        unet=dataclasses.replace(flow_cfg.unet, num_mid_blocks=1))


def flow_first_grads(cfg, batch, device, seed=5, double=False):
    """First-step gradients of the flow `cfg` initialised from `seed` on
    `batch` with the draws of `seed`, on `device`; in float64 throughout
    (the UNet's attention too) with `double`. Returns them and (model,
    state, batch, draws) for more steps."""
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.train import steps

    model, state = _train_state(flow_mod.FlowModel(cfg), device, seed)
    b = _on(batch, device)
    if double:
        model.double()
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in b.items()}
    draws = _flow_draws(cfg, batch, device, seed)
    grads = first_grads(model, steps.make_flow_loss_fn(model)(b, draws))
    return grads, (model, state, b, draws)


def flow_leaves(names):
    """(the conformer's key biases, whose gradient is 0 by symmetry: a key
    bias adds one constant to each query row's scores; the UNet's to_q
    and to_k weights, whose gradient comes only through K2's dq and dk)."""
    return ([n for n in names if n.endswith("linear_k.bias")],
            [n for n in names if n.startswith("estimator.")
             and n.endswith(("to_q.weight", "to_k.weight"))])


def flow_cross_check(full_flow_cfg, batch, device="cuda", steps_n=2):
    """Phase 22: the flow at reduced depth, the same weights, batch and
    draws on `device` and on the CPU, and a float64 run on the CPU for
    the first-step gradients: phase 9's checks on every leaf, with both
    runs' distances to the float64 run printed (compare_training)."""
    from minimax_speech_torch.train import steps

    cfg = reduced_flow(full_flow_cfg)
    truth, _ = flow_first_grads(cfg, batch, "cpu", double=True)
    runs = {}
    for dev in ("cpu", device):
        grads, (model, state, b, draws) = flow_first_grads(cfg, batch, dev)
        step = steps.make_flow_train_step(model, device=dev)
        metrics = []
        for _ in range(steps_n):
            state, m = step(state, b, draws)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[dev] = (metrics, grads, {n: p.detach().cpu() for n, p in
                                      model.named_parameters()})
        del model, state, b
    symmetric, k2_leaves = flow_leaves(list(truth))
    compare_training(runs, device, steps_n, "cross-flow",
                     "flow, 1 mid UNet stage, 1+1 encoder blocks",
                     symmetric=symmetric, k2_leaves=k2_leaves, truth=truth)


def remat_lm(lm_cfg, mode: str):
    """lm_cfg with per-layer remat off ("off") or under policy `mode`."""
    return dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
        lm_cfg.qwen, remat=mode != "off",
        remat_policy="dots" if mode == "off" else mode))


def k2_per_step(lm_cfg, forwards: int, backwards: int, mode: str) -> tuple:
    """(K2's expected {forward, backward} launches, K1's) per step of an
    LM step with `forwards` forward passes of which `backwards` are under
    grad: a remat mode recomputes each layer's forward once in the
    backward."""
    n = lm_cfg.qwen.n_layers
    recompute = backwards if mode != "off" else 0
    return {"forward": n * (forwards + recompute),
            "backward": n * backwards}, 0


def measured_steps(step, state, args, per_step, what: str, card: str,
                   device="cuda", timed: int = 5, base: int = 0) -> dict:
    """Phases 28 and 29: 2 warm-up steps of step(state, *args), `timed`
    counted and timed ones (each must launch (K2's counts, K1's count)
    `per_step` on the card, none on the CPU), then one profiled. Returns
    every step's metrics, the median step_s, the peak of device memory
    over the warm-up and timed steps less `base` (the bytes allocated
    before the phase built its models: earlier phases' leftovers) and
    the profile."""
    import torch

    on_card = device == "cuda"
    expect = per_step if on_card else ({"forward": 0, "backward": 0}, 0)
    metrics, secs = [], []

    def one():
        t0 = time.perf_counter()
        _, m = step(state, *args)
        m = {k: float(v) for k, v in m.items()}  # syncs
        if on_card:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"{what} step {state.step}: {m}")
        metrics.append(m)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        one()
    reset_counts()
    for _ in range(timed):
        one()
    k2, k1 = read_counts()
    if (k2, k1) != ({k: n * timed for k, n in expect[0].items()},
                    expect[1] * timed):
        raise AssertionError(f"{what}: {timed} steps launched K2 {k2} and "
                             f"K1 {k1}, expected {expect} per step")
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    prof = profile_step(one, f"one {what} step") if on_card else {}
    step_s = statistics.median(secs[2: 2 + timed])
    memory = (f"{peak / 2**30:.2f} GiB above {base / 2**30:.2f} GiB held "
              f"before" if on_card else "not measured")
    log(f"[train] {card} | {what} | median step_s {step_s:.4f} (steps "
        f"{[round(x, 4) for x in secs[2: 2 + timed]]}) | peak memory "
        f"{memory} | K2 launches per step "
        f"{ {k: n / timed for k, n in k2.items()} }, K1 {k1 / timed}")
    return {"metrics": metrics, "step_s": step_s, "peak_gib": peak / 2**30,
            "profile": prof, "launches": sum(k2.values()),
            "per_step": {k: n / timed for k, n in k2.items()}}


def memory_in_use(device) -> int:
    """Bytes allocated on `device` (0 on the CPU)."""
    import torch
    return torch.cuda.memory_allocated() if device == "cuda" else 0


def remat_phase(lm_cfg, batch, card: str, off: dict,
                device="cuda") -> dict:
    """Phase 28: phase 7's LM and batch with remat "dots" and "none": 2
    warm-up and 3 timed steps each (step_s, peak memory, a profiled
    step); K2 48 + 24 launches per step. The first-step gradients of each
    within REMAT_GRAD_RTOL of each leaf's largest of a remat-off first
    step's. Remat off's step_s, peak and busy time are phase 7's record
    `off` (its step is the same)."""
    import torch

    from minimax_speech_torch.train import steps

    b = _on(batch, device)
    out, ref = {"off": off}, None
    base = memory_in_use(device)
    for mode in ("off", "dots", "none"):
        cfg = remat_lm(lm_cfg, mode)
        model, state = lm_state(cfg, device)
        grads = first_grads(model, steps.make_lm_loss_fn(model)(b)[0])
        if ref is None:  # remat off: the gradient baseline only
            ref = grads
            del model, state
            continue
        err = grad_errors(grads, ref)
        worst = max(err, key=err.get)
        log(f"[remat] {mode}: first-step gradients against remat off, "
            f"worst max |diff| {err[worst]:.2e} of the leaf's largest "
            f"({worst}; tol {REMAT_GRAD_RTOL:g})")
        if err[worst] > REMAT_GRAD_RTOL:
            raise AssertionError(f"remat {mode} changes the gradients")
        del grads
        rec = measured_steps(
            steps.make_lm_train_step(model, device=device), state, (b,),
            k2_per_step(cfg, 1, 1, mode), f"LM remat {mode}", card, device,
            timed=3, base=base)
        out[mode] = {k: rec[k] for k in ("step_s", "peak_gib", "per_step",
                                         "launches")}
        out[mode]["busy_ms"] = rec["profile"].get("busy_ms")
        del model, state
        if device == "cuda":
            torch.cuda.empty_cache()
    if device == "cuda":
        log(f"[remat] {card} | "
            + " | ".join(f"{m}: step_s {r['step_s']:.4f}, peak "
                         f"{r['peak_gib']:.2f} GiB, busy {r['busy_ms']} ms"
                         for m, r in out.items()))
    return out


def dpo_batch(lm_cfg, batch: int = LM_BATCH, pad_to: int = LM_PAD):
    """Phase 7's batch as the chosen plans, and rejected plans of the same
    texts with other speech (250-460 tokens, each length unlike its
    chosen one's) at the same pad, from numpy seed 1."""
    texts = []
    out = lm_batch(lm_cfg, batch, pad_to, texts_out=texts)
    n_chosen = np.random.default_rng(0).integers(250, 461, batch)  # its
    rng = np.random.default_rng(1)                    # first draw above
    n_rej = rng.integers(250, 461, batch)
    n_rej = np.where(n_rej == n_chosen, n_rej + 1, n_rej)
    rej = lm_plan(lm_cfg, texts, [rng.integers(
        0, lm_cfg.speech_token_size, n) for n in n_rej], pad_to)
    out.update({k + "_rej": v for k, v in rej.items()})
    return out


@functools.cache
def lm_weights(lm_cfg, seed: int, jitter_seed=None) -> dict:
    """The CPU state dict of SpeechLM(lm_cfg) initialised from `seed` (as
    _train_state initialises it); with jitter_seed, every leaf moved by
    DPO_JITTER times its spread (1 where it is constant) times N(0, 1)
    from jitter_seed. Made once per argument set for phases 28-31."""
    import torch

    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.utils import params_io

    if jitter_seed is not None:
        gen = torch.Generator().manual_seed(jitter_seed)
        out = {}
        for k, v in lm_weights(lm_cfg, seed).items():
            spread = float(v.std()) if v.numel() > 1 else 0.0
            out[k] = v + DPO_JITTER * (spread or 1.0) * torch.randn(
                v.shape, generator=gen)
        return out
    return params_io.init_params(
        llm_mod.SpeechLM(remat_lm(lm_cfg, "off")),
        torch.Generator().manual_seed(seed)).state_dict()


def lm_module(lm_cfg, device, seed: int = 0, jitter_seed=None):
    """SpeechLM(lm_cfg) on `device` holding a copy of lm_weights' weights
    (built without weights first: no initialiser runs)."""
    import torch

    from minimax_speech_torch.models import llm as llm_mod

    with torch.device("meta"):
        model = llm_mod.SpeechLM(lm_cfg)
    weights = lm_weights(remat_lm(lm_cfg, "off"), seed, jitter_seed)
    model.load_state_dict({k: v.to(device, copy=True)
                           for k, v in weights.items()}, assign=True)
    return model


def lm_state(lm_cfg, device, seed: int = 0):
    """_train_state's model and state, the weights from lm_weights."""
    from minimax_speech_torch.train import schedule, steps

    model = lm_module(lm_cfg, device, seed)
    return model, steps.make_train_state(model, schedule.make_optimizer(
        lr=TRAIN_LR, warmup_steps=0))


def dpo_models(lm_cfg, device, mode="off", seed=0):
    """(policy, its train state, the reference policy) on `device`: the
    policy initialised from `seed` (remat `mode`), the reference the same
    weights jittered from seed + 1 (lm_weights)."""
    model, state = lm_state(remat_lm(lm_cfg, mode), device, seed)
    return model, state, lm_module(lm_cfg, device, seed, seed + 1)


def dpo_phase(lm_cfg, batch, card: str, device="cuda") -> dict:
    """Phase 29: make_dpo_step at the width and depth of lm_cfg on the
    fixed DPO batch, the policy from phase 7's initialiser (seed 0) at
    that depth and the reference a jittered copy: 2 warm-up and 3 timed steps, a profiled
    one, with remat off (over its first 5 steps the loss must fall and
    the reward accuracy not fall), then with "dots"; K2 4 + 2 launches
    per layer and step off, 6 + 2 with remat, K1 none."""
    import torch

    from minimax_speech_torch.train import gan_steps

    b = _on(batch, device)
    out = {}
    base = memory_in_use(device)
    for mode in ("off", "dots"):
        model, state, ref = dpo_models(lm_cfg, device, mode)
        step = gan_steps.make_dpo_step(model, ref, DPO_BETA, device=device)
        rec = measured_steps(step, state, (b,),
                             k2_per_step(lm_cfg, 4, 2, mode),
                             f"DPO remat {mode}", card, device, timed=3,
                             base=base)
        m = rec["metrics"]
        if mode == "off":
            first, fifth = m[0], m[4]
            log(f"[dpo] {card} | 5 steps: dpo/loss {first['dpo/loss']:.5f}"
                f" -> {fifth['dpo/loss']:.5f}, reward_acc "
                f"{first['dpo/reward_acc']:.3f} -> "
                f"{fifth['dpo/reward_acc']:.3f}, chosen reward "
                f"{first['dpo/chosen_reward']:.5f} -> "
                f"{fifth['dpo/chosen_reward']:.5f}, rejected "
                f"{first['dpo/rejected_reward']:.5f} -> "
                f"{fifth['dpo/rejected_reward']:.5f}")
            if not (fifth["dpo/loss"] < first["dpo/loss"]
                    and fifth["dpo/reward_acc"] >= first["dpo/reward_acc"]):
                raise AssertionError("DPO: the loss did not fall or the "
                                     "reward accuracy fell in 5 steps")
        out[mode] = {k: rec[k] for k in ("step_s", "peak_gib", "per_step",
                                         "launches", "profile")}
        del model, state, ref, step
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def dpo_loss_of(model, ref, batch):
    """(DPO loss, the four sequence log-probs) of `model` against `ref`."""
    import torch

    from minimax_speech_torch.train import gan_steps
    from minimax_speech_torch.utils import losses

    with torch.no_grad():
        ref_c, ref_r = gan_steps._seq_logps(ref, batch)
    c, r = gan_steps._seq_logps(model, batch)
    return (losses.dpo_loss(c, r, ref_c, ref_r, DPO_BETA)[0],
            (c, r, ref_c, ref_r))


def dpo_cross_check(full_lm_cfg, batch, device="cuda", steps_n=2):
    """Phase 30: make_dpo_step at 2 layers, float32, the same weights,
    reference and batch (the first DPO_CROSS_BATCH pairs of `batch`) on
    the CPU (remat off) and on `device` (remat off, then "dots"). Each card run against the CPU run: the first step's
    sequence log-probs (policy and reference, chosen and rejected, the
    rewards' terms) within phase 9's metric limit, relative; the rewards
    of every step within what that limit allows them (DPO_BETA x
    TRAIN_METRIC_RTOL x 2 x the largest |log-prob|); then compare_training
    on the loss and the reward accuracy, the first-step gradients and the
    parameters after `steps_n` steps."""
    from minimax_speech_torch.train import gan_steps

    cfg = dataclasses.replace(full_lm_cfg, qwen=dataclasses.replace(
        full_lm_cfg.qwen, n_layers=2))
    batch = {k: v[:DPO_CROSS_BATCH] for k, v in batch.items()}

    def run(dev, mode):
        model, state, ref = dpo_models(cfg, dev, mode, seed=5)
        b = _on(batch, dev)
        loss, logps = dpo_loss_of(model, ref, b)
        grads = first_grads(model, loss)
        step = gan_steps.make_dpo_step(model, ref, DPO_BETA, device=dev)
        metrics = []
        for _ in range(steps_n):
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        return (metrics, grads, {n: p.detach().cpu() for n, p in
                                 model.named_parameters()},
                np.stack([x.detach().cpu().numpy() for x in logps]))

    cpu = run("cpu", "off")
    scale = float(np.abs(cpu[3]).max())
    for mode in ("off", "dots"):
        card = run(device, mode)
        logp_err = float((np.abs(card[3] - cpu[3]) / np.abs(cpu[3])).max())
        tol = DPO_BETA * TRAIN_METRIC_RTOL * 2 * scale
        worst = max(abs(a[k] - c[k]) for a, c in zip(card[0], cpu[0])
                    for k in ("dpo/chosen_reward", "dpo/rejected_reward"))
        log(f"[cross-dpo] remat {mode}: first-step sequence log-probs "
            f"{cpu[3].min():.1f}..{cpu[3].max():.1f}, worst rel diff "
            f"{logp_err:.2e} (tol {TRAIN_METRIC_RTOL:g}); rewards "
            f"{[round(m['dpo/chosen_reward'], 6) for m in card[0]]} vs "
            f"{[round(m['dpo/chosen_reward'], 6) for m in cpu[0]]} "
            f"(chosen), worst |diff| {worst:.2e} (tol {tol:.2e})")
        if logp_err > TRAIN_METRIC_RTOL or worst > tol:
            raise AssertionError("DPO log-probs or rewards differ between "
                                 "the card and the CPU")

        def keep(rec):
            return ([{"loss": m["dpo/loss"],
                      "reward_acc": m["dpo/reward_acc"]} for m in rec[0]],
                    rec[1], rec[2])

        compare_training({"cpu": keep(cpu), device: keep(card)}, device,
                         steps_n, "cross-dpo", f"DPO, 2 layers, remat {mode}")


# -- phases 32-34: training over two ranks ------------------------------------

def dist_backend() -> str:
    """NCCL with a card per rank; with one card the two ranks share it
    over gloo (NCCL refuses two ranks on one device)."""
    import torch
    return "nccl" if torch.cuda.device_count() >= 2 else "gloo"


def _dist_state(kind: str, model_cfg, device, mesh=None, seed: int = 0,
                weights=None):
    """Phase 7's (kind "lm", or "dpo" for the policy) or 20's (kind
    "flow") model from `seed` on `device` (cuda: this rank's card), and
    its train state on `mesh` (None: one process). With kind "dpo", also
    the reference policy: the same weights, each leaf moved by DPO_JITTER
    times its spread (lm_weights' rule), on the same tp slices. A
    shallower LM after a deeper one takes the deeper one's weights of
    its layers; `weights`, a file of torch.save'd initial weights from
    `seed` (the main process's lm_weights), is read in place of the
    initialiser's run, which takes a rank ~17 s at 6 LM layers."""
    import torch

    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.parallel.layers import shard_module
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.utils import params_io

    def build():
        return flow_mod.FlowModel(model_cfg) if kind == "flow" \
            else llm_mod.SpeechLM(model_cfg)

    dev = torch.cuda.current_device() if device == "cuda" else device
    key = (kind == "flow", model_cfg, seed)
    if key not in _INITIAL:  # the initialiser's draws, made once a process
        deeper = [k for k in _INITIAL if len(k) == 3 and not k[0]
                  and not key[0] and k[2] == seed and lm_depth(
                      k[1], model_cfg.qwen.n_layers) == model_cfg]
        if deeper:  # a shallower LM: a deeper one's first layers
            with torch.device("meta"):
                wanted = build().state_dict()
            initial = {n: _INITIAL[deeper[0]][n] for n in wanted}
        elif weights is not None:
            initial = torch.load(weights, mmap=True, weights_only=True)
        else:
            initial = params_io.init_params(
                build(), torch.Generator().manual_seed(seed)).state_dict()
        _INITIAL.clear()
        _INITIAL[key] = initial

    def load(tensors):
        with torch.device("meta"):
            model = build()
        model = model.to_empty(device=dev)
        model.load_state_dict(tensors)
        return model

    model = load(_INITIAL[key])
    tx = schedule.make_optimizer(lr=TRAIN_LR, warmup_steps=0)
    state = steps.make_train_state(model, tx, mesh,
                                   kind="flow" if kind == "flow" else "lm")
    if kind != "dpo":
        return model, state
    if ("reference",) + key not in _INITIAL:
        gen = torch.Generator().manual_seed(seed + 1)
        _INITIAL[("reference",) + key] = {
            k: v + DPO_JITTER * (float(v.std()) if v.numel() > 1 else 1.0)
            * torch.randn(v.shape, generator=gen)
            for k, v in _INITIAL[key].items()}
    ref = load(_INITIAL[("reference",) + key])
    if mesh is not None:
        shard_module(ref, mesh, "lm")
    return model, state, ref


# (is the flow, config, seed) -> the initial weights, on the CPU; with
# "reference" first, DPO's jittered reference of them
_INITIAL = {}


def _dist_step(kind, model, batch, dp_rank, dp, device, ref=None):
    """(the step's arguments: this rank's rows of `batch` on `device`, and
    for the flow its rows of the global batch's draws; the step). With
    kind "dpo", `ref` is the reference policy."""
    import torch

    from minimax_speech_torch.train import gan_steps, steps

    n = next(iter(batch.values())).shape[0] // dp
    rows = {k: v[dp_rank * n:(dp_rank + 1) * n] for k, v in batch.items()}
    dev = torch.cuda.current_device() if device == "cuda" else device
    b = _on(rows, dev)
    if kind == "flow":
        draws = _flow_draws(model.cfg, batch, dev).rows(dp_rank * n, n)
        return (b, draws), steps.make_flow_train_step(model, device=device)
    if kind == "dpo":
        return (b,), gan_steps.make_dpo_step(model, ref, DPO_BETA,
                                             device=device)
    return (b,), steps.make_lm_train_step(model, device=device)


@contextlib.contextmanager
def first_gradients(keep):
    """Within: train.steps.gradients passes its first result, the first
    step's gradients, to keep(grads), once."""
    from minimax_speech_torch.train import steps

    real, done = steps.gradients, []

    def capture(state, loss):
        grads = real(state, loss)
        if not done:
            done.append(True)
            keep(grads)
        return grads

    steps.gradients = capture
    try:
        yield
    finally:
        steps.gradients = real


def timed_collectives(run_step, device) -> tuple:
    """One call of run_step() with every torch.distributed collective
    timed on the host, the device synchronised before and after each (so
    the time is the collective's own, gloo's copies of CUDA tensors
    through the host included): (its result, the share of the step's
    wall time the collectives take, that wall time)."""
    import torch
    import torch.distributed as dist

    on = device == "cuda"
    spent = [0.0]
    names = ("all_reduce", "all_gather", "broadcast", "broadcast_object_list")
    real = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def call(*a, **kw):
            if on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if on:
                torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return call

    for n in names:
        setattr(dist, n, timed(real[n]))
    try:
        if on:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_step()
        if on:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(dist, n, real[n])
    return out, spent[0] / wall, wall


def traced_collectives(run_step, device) -> tuple:
    """One call of run_step() under torch.profiler, the card not
    synchronised around the collectives: (its result, {"wall_s": the
    step's wall time, "copy_ms": the card's time in copies between card
    and host, "events": the trace's collective events by name, [count,
    host ms, device ms]}). Under gloo the card sees a collective of CUDA
    tensors only as those copies; the exchange and the sum run on the
    host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on else [])
    if on:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = run_step()
        if on:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_ms(evt, self_only=False):
        names = (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total", "cuda_time_total"))
        return next((getattr(evt, n) for n in names if hasattr(evt, n)),
                    0.0) / 1e3

    words = ("allreduce", "all_reduce", "allgather", "all_gather",
             "broadcast", "gloo", "nccl")
    copy_ms, events = 0.0, {}
    for e in prof.key_averages():
        k = e.key.lower()
        if e.device_type == DeviceType.CUDA:
            if "memcpy" in k and ("dtoh" in k or "htod" in k):
                copy_ms += dev_ms(e, self_only=True)
        elif any(w in k for w in words):
            events[e.key] = [e.count, round(e.cpu_time_total / 1e3, 3),
                             round(dev_ms(e), 3)]
    return out, {"wall_s": wall, "copy_ms": copy_ms, "events": events}


def dist_train_job(kind: str, model_cfg, batch: dict, dp: int, tp: int,
                   steps_n: int, per_step, device="cuda",
                   weights=None) -> dict:
    """On every rank of a dp x tp mesh: phase 7's or 20's model (or
    DPO's), this rank's rows of `batch`; steps_n steps (K2's launches per
    step asserted against `per_step`), each step timed: with 4 steps or
    more the one before the last with its collectives timed on the host
    (timed_collectives) and the last under the profiler
    (traced_collectives), else the last with its collectives timed; the
    first step's gradients and the parameters after the steps gathered
    whole. Keeps rank 0's record on its card (_RUNS); returns every
    rank's step times (the first without its gradients' gather), which
    step was timed and which traced, peak memory, the collectives' share
    and the trace's reading."""
    import torch

    from minimax_speech_torch.parallel import mesh as mesh_lib
    from minimax_speech_torch.parallel.collectives import full_tensors

    tf32_off()
    on = device == "cuda"
    mesh = mesh_lib.make_mesh(dp, tp)
    if on:
        torch.cuda.reset_peak_memory_stats()
    model, state, *ref = _dist_state(kind, model_cfg, device, mesh,
                                     weights=weights)
    args, step = _dist_step(kind, model, batch, mesh.dp_rank, dp, device,
                            *ref)
    names = [n for n, _ in model.named_parameters()]
    main = mesh.is_main

    def whole(tensors):  # copies on rank 0's device, which compares them
        out = full_tensors([t.detach() for t in tensors], state.layouts,
                           mesh)
        return {n: t.clone() for n, t in zip(names, out)} if main else {}

    grads, gather_s = {}, []

    def keep(g):
        t0 = time.perf_counter()
        grads.update(whole(g))
        gather_s.append(time.perf_counter() - t0)

    metrics, secs, traced = [], [], None
    timed_i = steps_n - 2 if steps_n >= 4 else steps_n - 1
    traced_i = steps_n - 1 if steps_n >= 4 else None
    reset_counts()
    with first_gradients(keep):
        for i in range(steps_n):
            def run():
                return {k: float(v)
                        for k, v in step(state, *args)[1].items()}

            if i == timed_i:  # its collectives timed on the host
                m, share, wall = timed_collectives(run, device)
            elif i == traced_i:  # under the profiler
                m, traced = traced_collectives(run, device)
                wall = traced["wall_s"]
            else:
                t0 = time.perf_counter()
                m = run()  # syncs
                if on:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            secs.append(wall - (gather_s.pop() if gather_s else 0.0))
            metrics.append(m)
    k2, k1 = read_counts()
    got = ({k: n / steps_n for k, n in k2.items()}, k1 / steps_n)
    if not on:  # the CPU runs the kernels' plain versions
        per_step = ({"forward": 0, "backward": 0}, 0)
    if got != per_step:
        raise AssertionError(f"{kind} dp={dp} tp={tp} rank {mesh.rank}: K2 "
                             f"and K1 launches per step {got}, expected "
                             f"{per_step}")
    params = whole(state.params())
    peak = torch.cuda.max_memory_allocated() / 2**30 if on else None
    del model, state, args
    if on:
        torch.cuda.empty_cache()
    if main:  # kept in this process for the "compare" job
        _RUNS[(kind, (dp, tp))] = (metrics, grads, params)
    return {"step_s": secs, "peak_gib": peak, "collective_share": share,
            "timed_i": timed_i, "traced_i": traced_i, "traced": traced,
            "per_step": got}


def dist_reference_job(kind: str, model_cfg, batch: dict, steps_n: int,
                       device="cuda", weights=None) -> None:
    """Rank 0's single-process run of the same model on the whole batch:
    (metrics per step, first-step gradients, parameters after steps_n
    steps), kept on its device for dist_compare_job."""
    import torch.distributed as dist

    if dist.get_rank() != 0:
        return
    tf32_off()
    model, state, *ref = _dist_state(kind, model_cfg, device,
                                     weights=weights)
    args, step = _dist_step(kind, model, batch, 0, 1, device, *ref)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    metrics = []
    with first_gradients(lambda g: grads.update(zip(names, g))):
        for _ in range(steps_n):
            state, m = step(state, *args)
            metrics.append({k: float(v) for k, v in m.items()})
    params = {n: p.detach() for n, p in model.named_parameters()}
    _RUNS[(kind, "reference")] = (metrics, grads, params)


def dist_compare_job(kind: str, mesh, what: str, symmetric,
                     steps_n: int) -> None:
    """On rank 0: compare_training of the `mesh` run of `kind` against the
    one-process run (phase 9's limits), which it raises on; the run is
    dropped after."""
    import torch.distributed as dist

    def keep(run):  # DPO: phase 30's metrics (the rewards may be ~0)
        if kind != "dpo":
            return run
        return ([{"loss": m["dpo/loss"], "reward_acc": m["dpo/reward_acc"]}
                 for m in run[0]], *run[1:])

    if dist.get_rank() == 0:
        compare_training({"cpu": keep(_RUNS[(kind, "reference")]),
                          "dist": keep(_RUNS.pop((kind, mesh)))}, "dist",
                         steps_n, "dist", what, symmetric=symmetric)
        if not any(k[0] == kind and k[1] != "reference" for k in _RUNS):
            del _RUNS[(kind, "reference")]


_RUNS = {}  # a gang rank's runs, by (kind, mesh or "reference")


def dist_k2_phase(cases) -> dict:
    """Phases 32-33: K2 at the shapes each rank gives it, (name, (B, H, T,
    64), key lengths, mode) per case: against its plain version at
    K2_TOL in fp32 and bf16, then kernel, plain and SDPA timed (k2_timing)
    beside the bound. Returns the records by name."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(32)
    out = {}
    for name, shape, kv, mode in cases:
        k2_agreement([(shape, kv)], {mode: K2_MODES[mode]}, gen)
        out[name] = k2_timing(gen, shape, kv, mode)
    return out


def flow_symmetric(flow_cfg) -> list:
    """The flow's parameter names whose gradient is 0 by symmetry
    (flow_leaves)."""
    import torch

    from minimax_speech_torch.models import flow as flow_mod
    with torch.device("meta"):
        names = [n for n, _ in flow_mod.FlowModel(flow_cfg).named_parameters()]
    return flow_leaves(names)[0]


def world1_phase(lm_cfg, batch, device="cuda", backend="nccl"):
    """Phase 32, first part: world size 1 through the distributed code on
    NCCL (the default group, a 1 x 1 mesh, the step's loss with its dp
    group and steps.gradients): phase 7's first step's loss and every
    leaf's gradient within REMAT_GRAD_RTOL of the leaf's largest against
    the one-process step on the same module."""
    from minimax_speech_torch.parallel import mesh as mesh_lib
    from minimax_speech_torch.train import steps
    from minimax_speech_torch.utils import distributed

    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend, device)
    try:
        model, plain = lm_state(lm_cfg, device)  # phases 28-31's weights
        tx = plain.optimizer
        meshed = steps.make_train_state(model, tx, mesh_lib.make_mesh(1, 1))
        b = _on(batch, device)
        out = {}
        for name, state in (("plain", plain), ("nccl", meshed)):
            loss, _ = steps.make_lm_loss_fn(model)(b, group=state.dp_group)
            g = steps.gradients(state, loss)
            out[name] = (float(loss), dict(zip(
                [n for n, _ in model.named_parameters()],
                [x.detach().cpu() for x in g])))
            del g, loss
        err = grad_errors(out["nccl"][1], out["plain"][1])
        worst = max(err, key=err.get)
        rel = abs(out["nccl"][0] - out["plain"][0]) / abs(out["plain"][0])
        log(f"[dist] world size 1 on {backend} (1 x 1 mesh): first-step loss "
            f"{out['nccl'][0]:.6f} vs {out['plain'][0]:.6f} (rel diff "
            f"{rel:.2e}), gradient per leaf worst max |diff| "
            f"{err[worst]:.2e} of the leaf's largest ({worst}; tol "
            f"{REMAT_GRAD_RTOL:g})")
        if err[worst] > REMAT_GRAD_RTOL or rel > REMAT_GRAD_RTOL:
            raise AssertionError("world size 1 on NCCL differs from one "
                                 "process")
        del model, plain, meshed, out
    finally:
        distributed.shutdown()


def dist_phase(gang, kind: str, model_cfg, batch, card: str,
               backend: str, symmetric=(), device="cuda",
               meshes=((1, 2), (2, 1)), steps_n: int = DIST_STEPS,
               weights=None) -> dict:
    """Phase 32 (kind "lm", then "dpo") or 33 ("flow"): the step at each
    (dp, tp) of `meshes` on the gang's two ranks against rank 0's
    one-process step on the whole batch: compare_training's limits
    (phase 9's and 22's; for DPO phase 30's metrics) on the metrics of
    steps_n steps, every leaf's gathered first-step gradient and the
    parameters after the steps; K2's launches per step per rank asserted
    (a DPO step: four forwards, two under grad). Each rank's step_s is
    the median of its steps after the first (a process's warm-up) but
    the traced one (dist_train_job); the timed step less a plain one
    before it is what the timed step's syncs cost. Returns
    {"per_step": K2's launches per step per rank by path, "step_s": each
    rank's step_s}. weights: a file of the model's initial weights
    (_dist_state)."""
    n = (attn_calls_per_step(model_cfg.unet) if kind == "flow"
         else model_cfg.qwen.n_layers)
    per_step = ({"forward": 4 * n, "backward": 2 * n} if kind == "dpo"
                else {"forward": n, "backward": n}, 0.0)
    recs, job_s = {}, {}
    for mesh in meshes:
        t0 = time.perf_counter()
        recs[mesh] = gang.run("dist_train_job", kind, model_cfg, batch,
                              *mesh, steps_n, per_step, device, weights)
        job_s[mesh] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gang.run("dist_reference_job", kind, model_cfg, batch, steps_n, device,
             weights)
    log(f"[time] {kind} over ranks: the runs at (dp, tp) "
        + ", ".join(f"{m} {t:.1f} s" for m, t in job_s.items())
        + f", the one-process run {time.perf_counter() - t0:.1f} s")
    out = {"per_step": {}, "step_s": {}}
    for (dp, tp), ranks in recs.items():
        what = (f"{kind} dp={dp} tp={tp}, 2 ranks over {backend}, "
                f"{batch[next(iter(batch))].shape[0] // dp} rows a rank")
        # rank 0 holds both runs on its card and compares them there
        gang.run("dist_compare_job", kind, (dp, tp), what, symmetric,
                 steps_n)
        r0 = ranks[0]
        ti, tr = r0["timed_i"], r0["traced_i"]
        extra = ""
        if ti >= 2:  # a plain step after the first precedes the timed one
            syncs = [round(r["step_s"][ti] - r["step_s"][ti - 1], 4)
                     for r in ranks]
            extra += f", the timed step's syncs add per rank {syncs} s"
        if tr is not None:
            walls = [r["traced"]["wall_s"] for r in ranks]
            copies = [round(r["traced"]["copy_ms"] / 1e3 / w, 4)
                      for r, w in zip(ranks, walls)]
            extra += (
                f"; the traced step (profiler, no syncs): wall per rank "
                f"{[round(w, 4) for w in walls]} s, the card's copies to "
                f"and from the host {copies} of it, rank 0's collective "
                f"events [count, host ms, device ms] "
                f"{r0['traced']['events']}")
        log(f"[dist] {card} | {what}: step_s per rank "
            f"{[[round(s, 4) for s in r['step_s']] for r in ranks]}, peak "
            f"memory per rank (GiB) {[r['peak_gib'] for r in ranks]}, "
            f"share of step {ti + 1} in its collectives (host-timed, the "
            f"card synchronised around each) per rank "
            f"{[r['collective_share'] for r in ranks]}{extra}; K2 "
            f"launches per step per rank {r0['per_step'][0]} "
            f"(asserted on every rank), K1 {r0['per_step'][1]}")
        path = f"{kind}_train_dp{dp}_tp{tp}"
        out["per_step"][path] = r0["per_step"][0]
        out["step_s"][path] = [statistics.median(
            t for i, t in enumerate(r["step_s"]) if 0 < i != tr)
            for r in ranks]
    out["steps"] = steps_n
    return out


CLI_WORKER = "--cli-worker"


def cli_worker(argv) -> int:
    """A rank of phase 34, started by cli/launch.py as `python -m
    chip_smoke --cli-worker <cli/train.py arguments>`: cli/train.main
    with the kernels' launch counts printed at its end."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from minimax_speech_torch.cli import train as train_cli

    reset_counts()
    state = train_cli.main(argv)
    k2, k1 = read_counts()
    print(json.dumps({"cli_worker": {"step": state.step, "k2": k2,
                                     "k1": k1}}), flush=True)
    return 0


def launch_phase(card: str, backend: str, device="cuda",
                 config="configs/default.yaml",
                 overrides=(f"model.lm.qwen.n_layers={LAUNCH_LM_LAYERS}",)):
    """Phase 34: python -m minimax_speech_torch.cli.launch --nproc 2, each
    rank cli/train.main (through cli_worker, which prints K2's
    launches) --model llm --tp 2 at full width (LAUNCH_LM_LAYERS layers)
    for one epoch of phase 8's corpus (batch_size 8, plans padded to
    512), then a second gang
    that resumes at the saved step and writes --export_npz, gathered to
    rank 0, which the port's SpeechLM loads. Each rank of the first gang
    must launch K2 once forward and once backward per layer and step."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.utils import params_io

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="launch_", dir=scratch))
    try:
        lst = write_corpus(root)
        npz = root / "lm.npz"
        train = [CLI_WORKER, "--model", "llm", "--config",
                 str(repo / config), "--train_data", str(lst),
                 "--model_dir", str(root / "exp"), "--tp", "2",
                 "--backend", backend, "--max_epoch", "1",
                 *sum((["--override", o] for o in (
                     "train.batch_size=8", "train.pad_seq=512",
                     "train.pad_ref=224", "train.save_per_step=2",
                     "train.warmup_steps=0", "train.log_interval=1",
                     *overrides)), [])]
        calls = []
        for i, extra in enumerate(([], ["--export_npz", str(npz)])):
            logs = root / f"logs{i}"
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "minimax_speech_torch.cli.launch",
                 "--nproc", "2", "--max_restarts", "0", "--module",
                 "chip_smoke", "--device", device, "--log_dir", str(logs),
                 "--", *train, *extra], cwd=repo, capture_output=True,
                text=True, timeout=600)
            secs = time.perf_counter() - t0
            texts = [(logs / f"rank{k}.attempt0.log").read_text()
                     for k in range(2)]
            if r.returncode != 0:
                raise AssertionError(f"launch exited {r.returncode}: "
                                     f"{r.stderr[-2000:]}\n{texts[0][-3000:]}"
                                     f"\n{texts[1][-3000:]}")
            counts = [json.loads(next(
                line for line in t.splitlines()
                if line.startswith('{"cli_worker"')))["cli_worker"]
                for t in texts]
            calls.append((secs, counts, texts[0]))
        (s1, c1, log1), (s2, c2, log2) = calls
        steps_n = c1[0]["step"]
        cfg = cfg_lib.load_tts_config(str(repo / config),
                                      list(overrides)).lm
        n = cfg.qwen.n_layers
        per = [{k: v / max(steps_n, 1) for k, v in c["k2"].items()}
               for c in c1]
        rows = [json.loads(line) for line in (
            root / "exp" / "llm_metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in rows if "loss" in r]
        with torch.device("meta"):  # no initialiser: the export's weights
            lm = llm_mod.SpeechLM(cfg)
        lm = params_io.load_flax_params(lm.to_empty(device=device),
                                        params_io.load_params(str(npz)))
        finite = all(bool(p.isfinite().all()) for p in lm.parameters())
        log(f"[launch] {card} | cli/launch.py --nproc 2, cli/train.py "
            f"--model llm --tp 2 over {backend}: one epoch of {steps_n} "
            f"steps in {s1:.1f} s (losses {[round(x, 4) for x in losses]}), "
            f"K2 launches per step per rank {per}, K1 "
            f"{[c['k1'] for c in c1]}; second gang resumed at step "
            f"{c2[0]['step']} and exported in {s2:.1f} s; the port loads "
            f"the export, finite {finite}")
        want = {"forward": n, "backward": n} if device == "cuda" \
            else {"forward": 0, "backward": 0}
        if steps_n < 1 or any(p != want for p in per) or \
                any(c["k1"] for c in c1) or not losses or \
                not np.isfinite(losses).all() or \
                f"resumed from step {steps_n}" not in log2 or \
                c2[0]["step"] != steps_n or not finite:
            raise AssertionError(f"launch phase: steps {steps_n}, K2 per "
                                 f"step {per}, resumed {c2}, losses {losses}")
        return {"per_step": per[0], "launches": sum(c1[0]["k2"].values())}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_time(n: int, t0: float) -> float:
    now = time.perf_counter()
    log(f"[time] phase {n}: {now - t0:.1f} s")
    return now


def voice(hift, seed: int) -> float:
    """Set HiFT's f0 classifier bias to an f0 drawn from `seed` in
    [100, 300] Hz, so that most frames are voiced (random weights leave
    f0 far below the 10 Hz threshold, where the sine source is 0)."""
    import torch

    f0 = float(np.random.default_rng(seed).uniform(100.0, 300.0))
    with torch.no_grad():
        hift.f0_predictor.classifier.bias.fill_(f0)
    return f0


def voiced_share(f0, cfg) -> float:
    return float((f0 > cfg.nsf_voiced_threshold).float().mean())


def phase_tol(n: int, s_max: float) -> float:
    """Cycles that a float32 cumsum of n phase increments reaching s_max
    cycles may lie from a float64 one: ceil(log2 n) / 2 ulp(s_max), as a
    tree-shaped scan rounds each partial sum at most ceil(log2 n) times
    by at most half an ulp (tests/test_torch_hift.py). The port sums in
    float64 (hifigan.harmonic_phase) and should lie far inside it."""
    return math.ceil(math.log2(n)) / 2 * 2.0 ** (
        math.floor(math.log2(s_max)) - 23)


def mel_pcm_tol(hift, gaps, f0_card, f0_cpu):
    """Phase 26's PCM limit in LSB and its derivation: the latent mode's
    PCM_TOL_LSB, plus 32767 times HiFT's gap card vs CPU at phase 23 (the
    decode on one shared source, and DECODE_GAIN times the source's gap,
    which is the harmonic phases' cumsum), plus DECODE_GAIN times the
    source change that the two sides' f0 (recorded here) can cause: f0
    off by df over a frame moves the highest harmonic's phase by
    (nb_harmonics + 1) df 480 / sr cycles, the merged source by sum|w|
    alpha 2 pi times that."""
    c = hift.cfg
    dec_gap, src_gap = gaps
    w = float(hift.source_linear.weight.detach().abs().sum())
    drift = (c.nb_harmonics + 1) * c.total_upsample / c.sampling_rate * \
        float((f0_card - f0_cpu).abs().sum(-1).max())
    src = src_gap + w * c.nsf_alpha * 2 * math.pi * drift
    tol = PCM_TOL_LSB + math.ceil(32767 * (dec_gap + DECODE_GAIN * src))
    return tol, (f"{PCM_TOL_LSB} + 32767 x (decode gap {dec_gap:.1e} + "
                 f"{DECODE_GAIN:g} x (source gap {src_gap:.1e} + f0 drift "
                 f"{drift:.1e} cycles x {w * c.nsf_alpha * 2 * math.pi:.2f}))")


def hift_phase(hift_cfg, card: str, device="cuda") -> dict:
    """Phase 23: HiFT at full width (random weights, seed HIFT_SEED, voiced
    f0) on a HIFT_FRAMES-frame mel, card vs CPU: each side's harmonic
    phase against a float64 cumsum of its own f0 (phase_tol); the card's
    decode of the CPU's source against the CPU's waveform
    (HIFT_DECODE_TOL); the whole forward within DECODE_GAIN times the
    sources' gap plus that; the forward's time as CUDA events and audio
    seconds per second. Returns the weights and the two gaps (phase 26
    derives its PCM limit from them)."""
    import torch

    from minimax_speech_torch.models import hifigan
    from minimax_speech_torch.utils import params_io

    cpu = params_io.init_params(hifigan.HiFTGenerator(hift_cfg),
                                torch.Generator().manual_seed(HIFT_SEED))
    f0_hz = voice(cpu.eval(), HIFT_SEED)
    dev = hifigan.HiFTGenerator(hift_cfg).to(device).eval()
    dev.load_state_dict(cpu.state_dict())
    mel = torch.as_tensor(np.random.default_rng(HIFT_SEED).standard_normal(
        (1, HIFT_FRAMES, hift_cfg.in_channels)), dtype=torch.float32)
    mel_d = mel.to(device)
    up, sr = hift_cfg.total_upsample, hift_cfg.sampling_rate
    n = HIFT_FRAMES * up
    harmonics = np.arange(1, hift_cfg.nb_harmonics + 2)
    phase = {}
    with torch.no_grad():
        wav_cpu, src_cpu = cpu(mel)
        f0 = {"cpu": cpu.predict_f0(mel), "card": dev.predict_f0(mel_d)}
        for side, f in f0.items():
            f_up = torch.repeat_interleave(f, up, dim=-1)
            got = hifigan.harmonic_phase(f_up, hift_cfg).double().cpu() \
                .numpy() / (2 * np.pi)
            cum = np.cumsum(f_up.double().cpu().numpy()[:, :, None]
                            * harmonics / sr, axis=1)
            phase[side] = (float(np.abs((got - cum + 0.5) % 1.0 - 0.5).max()),
                           phase_tol(n, float(cum.max())))
        shared = dev.decode(mel_d, src_cpu.to(device)).cpu()
        wav_dev, src_dev = (x.cpu() for x in dev(mel_d))

    def call():
        with torch.no_grad():
            dev(mel_d)
    if device == "cuda":
        ms = cuda_ms(call, iters=10)
    else:  # a rehearsal on the CPU: host time
        t0 = time.perf_counter()
        call()
        ms = (time.perf_counter() - t0) * 1e3
    share = voiced_share(f0["cpu"], hift_cfg)
    dec_gap = float((shared - wav_cpu).abs().max())
    src_gap = float((src_dev - src_cpu).abs().max())
    fwd_gap = float((wav_dev - wav_cpu).abs().max())
    fwd_tol = dec_gap + DECODE_GAIN * src_gap + HIFT_DECODE_TOL
    audio_s = n / sr
    log(f"[hift] {card} | base {hift_cfg.base_channels}, up "
        f"{list(hift_cfg.upsample_rates)}, {HIFT_FRAMES} frames ({audio_s:.1f}"
        f" s), f0 bias {f0_hz:.1f} Hz, voiced share {share:.3f}; harmonic "
        f"phase against float64, cycles: "
        f"{ {k: f'{d:.2e} (tol {t:.2e})' for k, (d, t) in phase.items()} }; "
        f"decode of the CPU's source, card vs CPU: max |diff| {dec_gap:.2e} "
        f"(tol {HIFT_DECODE_TOL:g}); sources {src_gap:.2e} apart; whole "
        f"forward {fwd_gap:.2e} (tol {fwd_tol:.2e}); peak "
        f"{float(wav_dev.abs().max()):.3f}; forward {ms:.2f} ms per call "
        f"({'CUDA events' if device == 'cuda' else 'host clock'}, B=1), "
        f"{audio_s / (ms / 1e3):.1f} audio-s per s")
    ok = (share >= 0.5 and all(d <= t for d, t in phase.values())
          and dec_gap <= HIFT_DECODE_TOL and fwd_gap <= fwd_tol
          and bool(torch.isfinite(wav_dev).all())
          and float(wav_dev.abs().max()) <= hift_cfg.audio_limit)
    if not ok:
        raise AssertionError("HiFT on the card differs from the CPU")
    return {"state": cpu.state_dict(), "gaps": (dec_gap, src_gap),
            "ms": ms, "audio_s_per_s": audio_s / (ms / 1e3)}


def mel_synthesis_phase(pipe, inputs, card: str, device="cuda"):
    """Phase 24: mel mode at full width with phase 4's LM at PATH_LM_LAYERS
    layers: synthesize_fused and the unfused synthesize, each with
    HiFT's seconds and 560 K1 launches per flow call; a chunked
    StreamingSession: time to first chunk, seconds per hop with HiFT's
    full-prefix decode in each, K1's launches per path as phase 11 counts
    them. Returns K1's launches by path."""
    import torch

    from minimax_speech_torch.infer.session import StreamingSession
    from minimax_speech_torch.kernels import flash_attention as fa

    cfg = pipe.cfg
    args = _prompt(pipe, inputs)
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    on = device == "cuda"
    hift_s = []

    def timed(fn):  # the call's seconds, queued work before it excluded
        def run(*a, **kw):
            if on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if on:
                torch.cuda.synchronize()
            hift_s.append(round(time.perf_counter() - t0, 4))
            return out
        return run

    pipe.decode = timed(pipe.decode)
    launches = {}
    try:
        for label, fn, seed in (("fused", pipe.synthesize_fused, 2),
                                ("unfused", pipe.synthesize, 3)):
            hift_s.clear()
            fa.launches = 0
            gen = torch.Generator(device=device).manual_seed(seed)
            wav, tim = fn(*args, generator=gen, return_timings=True)
            launches[label] = fa.launches
            log(f"[mel] {card} | {label} synthesis, mel mode: tokens "
                f"{tim['tokens']}, audio_s {tim['audio_s']:.2f}, total_s "
                f"{tim['total_s']:.4f}, rtf "
                f"{tim['total_s'] / tim['audio_s']:.5f}, lm_s "
                f"{tim['lm_s']:.4f}, HiFT {hift_s[0]:.4f} s "
                f"({hift_s[0] / tim['total_s']:.3f} of total_s); K1 "
                f"launches {fa.launches}")
            if tim["tokens"] != GEN_TOKENS or len(wav) != GEN_TOKENS * 960 \
                    or not np.isfinite(wav).all() or np.abs(wav).max() > 1 \
                    or (on and fa.launches != expect):
                raise AssertionError(f"mel-mode {label} synthesis: {tim}, K1 "
                                     f"{fa.launches} (expected {expect})")
    finally:
        del pipe.decode
    sess = StreamingSession(pipe, chunked=True)
    sess._hift_prefix = timed(sess._hift_prefix)
    hift_s.clear()
    with K1Watch(pipe) as watch:
        for name in ("prefill", "step", "final"):
            watch.count(sess.cfs, name, name, device)
        fa.launches = 0
        gen = torch.Generator(device=device).manual_seed(4)
        t0 = time.perf_counter()
        stamps, chunks = [], []
        for chunk in sess.synthesize_stream(*args, generator=gen):
            stamps.append(time.perf_counter() - t0)
            chunks.append(chunk)
    total = np.concatenate([c.audio for c in chunks])
    hops = np.diff([0.0] + stamps).round(4).tolist()
    counts = watch.per_call
    log(f"[mel] {card} | chunked StreamingSession, mel mode: time to first "
        f"chunk {stamps[0]:.4f} s, total {stamps[-1]:.4f} s, {len(chunks)} "
        f"chunks, audio_s {len(total) / 24000:.2f}, tokens "
        f"{chunks[-1].tokens}; seconds per hop {hops}, HiFT's full-prefix "
        f"decode in each {hift_s}; K1 launches {counts}, flow s per call "
        f"{watch.secs}")
    want = dict(prefill=[expect], step=[0] * len(counts.get("step", [])),
                final=[0])
    ok = (chunks[-1].final and chunks[-1].tokens == GEN_TOKENS
          and np.isfinite(total).all() and np.abs(total).max() <= 1.1
          and len(total) == GEN_TOKENS * 960 and len(chunks) >= 3)
    if not ok or (on and {k: counts.get(k) for k in want} != want):
        raise AssertionError(f"mel-mode streaming: {len(total)} samples, K1 "
                             f"{counts} (expected {want})")
    return {"mel_fused": launches["fused"], "mel_unfused": launches["unfused"],
            "mel_stream_prefill": counts["prefill"][0],
            "mel_stream_per_hop_chunked": counts["step"]}


def mel_serve_phase(pipe, card: str, device="cuda",
                    config="configs/default.yaml") -> int:
    """Phase 25: one BatchSynthesizer call of the first 4 SERVE_SPECS in
    mel mode at full width, 560 K1 launches; then cli/synthesize.main
    --override model.output_type=mel, unfused, writing a 24 kHz wav.
    Returns the call's K1 launches."""
    import torch

    from minimax_speech_torch.infer.serving import BatchSynthesizer
    from minimax_speech_torch.kernels import flash_attention as fa

    cfg = pipe.cfg = fixed_length(pipe.cfg, SERVE_TOKENS)
    reqs = serve_requests(pipe, SERVE_SPECS[:4])
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    fa.launches = 0
    wavs, tim = BatchSynthesizer(pipe).synthesize_batch(
        reqs, generator=torch.Generator(device=device).manual_seed(25),
        return_timings=True)
    launches = fa.launches
    want = [expected_tokens(cfg, r) for r in reqs]
    log(f"[mel-serve] {card} | BatchSynthesizer, mel mode, B=4: tokens "
        f"{tim['tokens']} (expected {want}), audio_s {tim['audio_s']:.2f}, "
        f"total_s {tim['total_s']:.4f} (lm_s {tim['lm_s']:.4f}), audio-s "
        f"per wall-s {tim['audio_s'] / tim['total_s']:.4f}; K1 launches "
        f"{launches}")
    if tim["tokens"] != want or any(len(w) != n * 960 or not np.isfinite(
            w).all() for w, n in zip(wavs, want)) or (
            device == "cuda" and launches != expect):
        raise AssertionError(f"mel-mode batched synthesis: {tim}, K1 "
                             f"{launches} (expected {expect})")
    synth_cli_phase(config, device=device, streams=(False,),
                    extra=("model.output_type=mel",))
    return launches


def upstream_flow_state(cfg, seed: int) -> dict:
    """A random state dict in the upstream flow.pt layout (CosyVoice2's
    CausalMaskedDiffWithXvec names, as utils/convert.flow_params reads
    them) for the flow config `cfg`, one UNet stage: weights N(0, 0.05),
    norm scales 1 + N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def lin(p, out, inp, bias=True, k=None):
        w = a(out, inp) if k is None else a(out, inp, k)
        return {p + "weight": w, **({p + "bias": a(out)} if bias else {})}

    def norm(p, n):
        return {p + "weight": a(n) + 1.0, p + "bias": a(n)}

    def speaker(p, c):
        sd = lin(p + "init.", c.model_dim, c.mel_dim, k=1)
        sd |= lin(p + "output_proj.", c.output_dim, c.model_dim)
        for i in range(c.num_blocks):
            b = f"{p}attn.{i}."
            sd |= norm(b + "norm.", c.model_dim)
            sd |= lin(b + "qkv.", 3 * c.model_dim, c.model_dim, k=1)
            sd |= lin(b + "proj_out.", c.model_dim, c.model_dim, k=1)
        return sd

    def causal_block(p, din, dout):
        return lin(p + "block.0.", dout, din, k=3) | norm(p + "block.2.", dout)

    e, u = cfg.encoder, cfg.unet
    d, h = e.output_size, e.attention_heads
    sd = {"input_embedding.weight": a(cfg.vocab_size, cfg.input_size)}
    sd |= lin("spk_embed_affine_layer.", cfg.output_size, cfg.spk_embed_dim)
    sd |= lin("encoder_proj.", cfg.output_size, d)
    sd |= speaker("speaker_encoder.", cfg.speaker)
    for name, inp in (("embed", e.input_size), ("up_embed", d)):
        sd |= lin(f"encoder.{name}.out.0.", d, inp)
        sd |= norm(f"encoder.{name}.out.1.", d)
    sd |= lin("encoder.pre_lookahead_layer.conv1.", d, d,
              k=e.pre_lookahead_len + 1)
    sd |= lin("encoder.pre_lookahead_layer.conv2.", d, d, k=3)
    sd |= lin("encoder.up_layer.conv.", d, d, k=2 * e.up_stride + 1)
    sd |= norm("encoder.after_norm.", d)
    for group, n in (("encoders", e.num_blocks),
                     ("up_encoders", e.num_up_blocks)):
        for i in range(n):
            p = f"encoder.{group}.{i}."
            sd |= norm(p + "norm_mha.", d) | norm(p + "norm_ff.", d)
            for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
                sd |= lin(f"{p}self_attn.{name}.", d, d)
            sd |= lin(p + "self_attn.linear_pos.", d, d, bias=False)
            sd[p + "self_attn.pos_bias_u"] = a(h, d // h)
            sd[p + "self_attn.pos_bias_v"] = a(h, d // h)
            sd |= lin(p + "feed_forward.w_1.", e.linear_units, d)
            sd |= lin(p + "feed_forward.w_2.", d, e.linear_units)
    (ch,) = u.channels
    temb, inner = 4 * ch, u.num_heads * u.attention_head_dim
    est = "decoder.estimator."
    sd |= lin(est + "time_mlp.linear_1.", temb, u.in_channels)
    sd |= lin(est + "time_mlp.linear_2.", temb, temb)
    blocks = [("down_blocks.0.", u.in_channels, True)] + [
        (f"mid_blocks.{i}.", ch, False) for i in range(u.num_mid_blocks)] + [
        ("up_blocks.0.", 2 * ch, True)]
    for p, din, conv in blocks:
        r = est + p + "0."
        sd |= causal_block(r + "block1.", din, ch)
        sd |= causal_block(r + "block2.", ch, ch)
        sd |= lin(r + "mlp.1.", ch, temb) | lin(r + "res_conv.", ch, din, k=1)
        for j in range(u.n_blocks):
            t = f"{est}{p}1.{j}."
            sd |= norm(t + "norm1.", ch) | norm(t + "norm3.", ch)
            for name in ("to_q", "to_k", "to_v"):
                sd |= lin(f"{t}attn1.{name}.", inner, ch, bias=False)
            sd |= lin(t + "attn1.to_out.0.", ch, inner)
            sd |= lin(t + "ff.net.0.proj.", 4 * ch, ch)
            sd |= lin(t + "ff.net.2.", ch, 4 * ch)
        if conv:
            sd |= lin(est + p + "2.", ch, ch, k=3)
    sd |= causal_block(est + "final_block.", ch, ch)
    sd |= lin(est + "final_proj.", u.out_channels, ch, k=1)
    return sd


def upstream_hift_state(c, seed: int) -> dict:
    """A random state dict in the upstream hift.pt layout (HiFTGenerator
    names, as utils/convert.hift_params reads them) for HiFTConfig `c`:
    weight-norm convs as weight_g / weight_v, the transposed ones (in,
    out, k) under the parametrizations names; the f0 classifier's bias at
    150 Hz, so that the source is voiced."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def wn(p, out, inp, k):
        return {p + "weight_g": a(out, 1, 1) + 1.0,
                p + "weight_v": a(out, inp, k), p + "bias": a(out)}

    def resblock(p, ch, k, n):
        sd = {}
        for i in range(n):
            sd |= wn(f"{p}convs1.{i}.", ch, ch, k)
            sd |= wn(f"{p}convs2.{i}.", ch, ch, k)
            sd[f"{p}activations1.{i}.alpha"] = a(1, ch, 1) + 1.0
            sd[f"{p}activations2.{i}.alpha"] = a(1, ch, 1) + 1.0
        return sd

    nfft2 = c.istft_n_fft + 2
    sd = wn("conv_pre.", c.base_channels, c.in_channels, 7)
    sd |= wn("conv_post.", nfft2,
             c.base_channels // 2 ** len(c.upsample_rates), 7)
    sd |= {"m_source.l_linear.weight": a(1, c.nb_harmonics + 1),
           "m_source.l_linear.bias": a(1)}
    down = np.cumprod([1] + list(c.upsample_rates[::-1][:-1]))[::-1]
    n_k = len(c.resblock_kernel_sizes)
    for i, k in enumerate(c.upsample_kernel_sizes):
        cin, ch = c.base_channels // 2 ** i, c.base_channels // 2 ** (i + 1)
        p = f"ups.{i}.parametrizations.weight."
        sd |= {p + "original0": a(cin, 1, 1) + 1.0,
               p + "original1": a(cin, ch, k), f"ups.{i}.bias": a(ch)}
        sd |= {f"source_downs.{i}.weight": a(
            ch, nfft2, 1 if down[i] == 1 else 2 * int(down[i])),
            f"source_downs.{i}.bias": a(ch)}
        sd |= resblock(f"source_resblocks.{i}.", ch,
                       c.source_resblock_kernel_sizes[i],
                       len(c.source_resblock_dilations[i]))
        for j in range(n_k):
            sd |= resblock(f"resblocks.{i * n_k + j}.", ch,
                           c.resblock_kernel_sizes[j],
                           len(c.resblock_dilations[j]))
    for i in range(5):
        sd |= wn(f"f0_predictor.condnet.{2 * i}.", c.f0_cond_channels,
                 c.in_channels if i == 0 else c.f0_cond_channels, 3)
    sd |= {"f0_predictor.classifier.weight": a(1, c.f0_cond_channels),
           "f0_predictor.classifier.bias": np.array([150.0], np.float32)}
    return sd


def convert_phase(pipes, inputs, card: str, device="cuda"):
    """Phase 27: random upstream-layout flow and hift state dicts (phase
    26's reduced flow, full-width HiFT), saved with torch.save and turned
    by cli/convert_checkpoint.main into flow.npz and codec.npz in a
    checkpoint directory beside phase 26's llm.npz and s3.npz. A mel-mode
    pipeline loaded from that directory, as cli/synthesize.py --ckpt_dir
    loads one, must hold the weights of one built on the card from the
    converter's trees in memory bit for bit, and give its token ids and,
    within PCM_TOL_LSB, its PCM: the same weights, noise and card, but
    the card's transposed convolutions (cuDNN's backward-data
    algorithms) do not sum in a fixed order, so two runs of one pipeline
    differ by a few LSB at these weights' gain (the spread of the direct
    pipeline's two runs is printed beside)."""
    import tempfile

    import torch

    from minimax_speech_torch.cli import convert_checkpoint as conv_cli
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.utils import params_io

    cfg, cpu = pipes[0], pipes[1]
    states = {"flow": upstream_flow_state(cfg.flow, 27),
              "hift": upstream_hift_state(cfg.hift, 28)}
    direct = TTSPipeline.from_flax(
        cfg, params_io.to_flax_params(cpu.lm),
        conv_cli.convert("flow", states["flow"], cfg),
        conv_cli.convert("hift", states["hift"], cfg),
        params_io.to_flax_params(cpu.s3), device=device)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="convert_", dir=scratch) as root:
        root = Path(root)
        ckpt = root / "ckpt"
        ckpt.mkdir()
        cfg_file = root / "config.yaml"  # JSON is YAML
        cfg_file.write_text(json.dumps({"model": dataclasses.asdict(cfg)}))
        for kind, out in (("flow", "flow"), ("hift", "codec")):
            tensors = {k: torch.from_numpy(a) for k, a in
                       states[kind].items()}
            torch.save({"state_dict": tensors} if kind == "hift" else
                       tensors, root / f"{kind}.pt")
            conv_cli.main(["--kind", kind, "--src", str(root / f"{kind}.pt"),
                           "--out", str(ckpt / f"{out}.npz"), "--config",
                           str(cfg_file)])
        params_io.save_params(str(ckpt / "llm.npz"), cpu.lm)
        params_io.save_params(str(ckpt / "s3.npz"), cpu.s3)
        loaded = TTSPipeline.from_flax(
            cfg, *(params_io.load_params(str(ckpt / f"{n}.npz"))
                   for n in ("llm", "flow", "codec", "s3")), device=device)
    secs = time.perf_counter() - t0
    same = all(torch.equal(a, b) for name, m in direct.models().items()
               for a, b in zip(m.state_dict().values(),
                               loaded.models()[name].state_dict().values()))
    g_top, g_fb = llm_mod.decode_noise(
        cfg.lm, cfg.max_speech_tokens, 1, torch.Generator().manual_seed(27))
    out, f0 = {}, []
    hook = direct.hift.f0_predictor.register_forward_hook(
        lambda m, a, o: f0.append(o.float().cpu()))
    for name, pipe in (("direct", direct), ("loaded", loaded),
                       ("direct again", direct)):
        wav, tim = pipe.synthesize_fused(
            *_prompt(pipe, inputs), gumbel_top=g_top, gumbel_fallback=g_fb,
            return_timings=True)
        out[name] = (tim["tokens"], np.round(wav * 32767).astype(np.int32))
    hook.remove()

    def gap(a, b):
        return int(np.abs(out[a][1] - out[b][1]).max()) if \
            out[a][1].shape == out[b][1].shape else None
    diff, spread = gap("direct", "loaded"), gap("direct", "direct again")
    share = voiced_share(torch.cat([f.flatten() for f in f0]), cfg.hift)
    log(f"[convert] {card} | upstream flow ({len(states['flow'])} tensors) "
        f"and hift ({len(states['hift'])}) state dicts through "
        f"cli/convert_checkpoint into a checkpoint directory and loaded in "
        f"{secs:.1f} s: weights identical to the converter's in memory "
        f"{same}; mel-mode synthesize_fused, tokens {out['direct'][0]} vs "
        f"{out['loaded'][0]}, PCM max |diff| {diff} LSB (tol {PCM_TOL_LSB}; "
        f"the direct pipeline's two runs {spread} LSB apart), peak "
        f"{int(np.abs(out['direct'][1]).max())}, voiced share {share:.3f}")
    if not same or out["direct"][0] != out["loaded"][0] or diff is None \
            or diff > PCM_TOL_LSB or share < 0.5 or not out["direct"][0]:
        raise AssertionError("the converted checkpoint differs from the "
                             "converter's trees")


# phases 35-38: codec and vocoder GAN training and offline extraction.
# Phases 35-36 run CLI-default batches at full width: the DAC 64 crops of
# 0.38 s (9120 samples, 19 latent frames), HiFT 16 of 1.02 s (24480
# samples, 51 mel frames) with pitch; a warm-up and GAN_ITERS timed
# iterations (disc step, then gen step). Phase 37 holds one iteration
# card vs CPU at reduced width (GAN_CROSS_*) on the same weights and draws
# at phase 9's limits in float64, and its float32 metrics. Its float32
# gradients are printed, not held: the discriminators' leaky ReLUs make
# the gradient jump where a pre-activation crosses 0, and a change of
# the input by GAN_NUDGE relative (float32 rounding's scale after a few
# layers) moves some float64 leaves by 1e-3 and more of their largest
# (phase 37 prints it; tests/test_torch_gan.py holds the jump). Then S3
# V1 over a 70 s mel (3 windows): codes
# identical, or a differing position's top two distances within
# V1_TIE_RTOL of each other (a tie that float32 rounding may break
# either way)
GAN_ITERS = 3
DAC_BATCH, DAC_SECONDS = 64, 0.38
HIFT_BATCH, HIFT_SECONDS = 16, 1.02
GAN_CROSS_BATCH, GAN_CROSS_SECONDS = 2, 0.3
GAN_NUDGE = 1e-6
V1_SECONDS, V1_TIE_RTOL = 70.0, 1e-5


def speechlike(rng, n: int, sr: int = 24000) -> np.ndarray:
    """n samples of a voiced tone (120-260 Hz, three harmonics) under a
    3-6 Hz syllable envelope, with noise, peak about 0.6."""
    t = np.arange(n) / sr
    f0 = rng.uniform(120.0, 260.0)
    tone = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3)) / k
               for k in (1, 2, 3))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 6) * t))
    return (0.3 * env * tone + 0.02 * rng.standard_normal(n)).astype(
        np.float32)


def gan_batch(kind: str, cfg, batch: int, seconds: float,
              seed: int = 0) -> dict:
    """A fixed GAN batch (numpy) from `seed`: DAC {"audio": (B, n)}, n a
    hop multiple; HiFT {"speech_feat" (B, T, 80) host mel, "audio" (B, T
    * hop), "pitch" (B, T) YIN f0}, as cli/train_hift.py's folder
    source builds them."""
    from minimax_speech_torch.ops import mel as mel_ops
    from minimax_speech_torch.ops.pitch import yin_f0

    rng = np.random.default_rng(seed)
    hop = cfg.hop_length if kind == "dac" else cfg.total_upsample
    n = int(seconds * 24000) // hop * hop
    audio = np.stack([speechlike(rng, n) for _ in range(batch)])
    if kind == "dac":
        return {"audio": audio}
    t = n // hop
    mel = mel_ops.hifigan_log_mel_np(audio).transpose(0, 2, 1)[:, :t]
    pitch = np.stack([yin_f0(a, 24000, hop)[:t] for a in audio])
    return {"speech_feat": mel.astype(np.float32), "audio": audio,
            "pitch": np.pad(pitch, ((0, 0), (0, t - pitch.shape[1])))}


def gan_draws(kind: str, cfg, batch: dict, device, seed: int = 0):
    """The iteration's draws for `batch` from a CPU generator seeded with
    `seed`, moved to `device`, so the card and the CPU share them."""
    import torch

    from minimax_speech_torch.train import gan_steps

    gen = torch.Generator().manual_seed(seed)
    if kind == "dac":
        return gan_steps.dac_eps(cfg, *batch["audio"].shape, gen).to(device)
    d = gan_steps.make_hift_draws(cfg, *batch["speech_feat"].shape[:2], gen)
    return gan_steps.HiFTDraws(d.phase.to(device), d.noise.to(device))


def gan_models(kind: str, cfg, device, seed: int = 0, disc_kw=None,
               dtype=None):
    """(generator, discriminator, (gen_step, disc_step), g_state,
    d_state): the generator of `cfg` and the kind's discriminator
    (disc_kw, or the CLI's default), initialised from `seed` (in
    `dtype`, default float32), with
    AdamW at TRAIN_LR as the CLIs build it (the DAC's weight decay 1e-3,
    its discriminator clipped at 10)."""
    import torch

    from minimax_speech_torch.models import dac_vae, discriminators, hifigan
    from minimax_speech_torch.train import gan_steps, schedule, steps
    from minimax_speech_torch.utils import params_io

    init = torch.Generator().manual_seed(seed)
    if kind == "dac":
        gen = dac_vae.DACVAE(cfg)
        disc = discriminators.DACDiscriminator(**(disc_kw or {}))
        clips, wd = (1e3, 10.0), 1e-3
    else:
        gen = hifigan.HiFTGenerator(cfg)
        disc = discriminators.CosyVoiceDiscriminator(**(disc_kw or {}))
        clips, wd = (1e3, 1e3), 0.0
    gen = params_io.init_params(gen, init).to(device, dtype)
    disc = params_io.init_params(disc, init).to(device, dtype)
    make = gan_steps.make_dac_steps if kind == "dac" \
        else gan_steps.make_hift_steps
    states = [steps.make_train_state(m, schedule.make_optimizer(
        lr=TRAIN_LR, warmup_steps=0, grad_clip=c, weight_decay=wd))
        for m, c in ((gen, clips[0]), (disc, clips[1]))]
    return gen, disc, make(gen, disc, device=device), *states


def gan_train_phase(kind: str, cfg, card: str, device="cuda",
                    iters: int = GAN_ITERS, batch: int | None = None,
                    seconds: float | None = None) -> dict:
    """Phases 35 (DAC-VAE) and 36 (HiFT): the CLI's models at the width
    of `cfg` on a fixed CLI-sized batch with fixed draws: a warm-up and
    `iters` timed iterations, each half's step_s, audio seconds per
    second, peak memory, one profiled iteration (busy time; shares of
    convolutions, GEMMs and FFTs; the host's idle share); every loss
    finite, K1 and K2 never launched. Returns the record."""
    import torch

    on_card = device == "cuda"
    batch = batch or (DAC_BATCH if kind == "dac" else HIFT_BATCH)
    seconds = seconds or (DAC_SECONDS if kind == "dac" else HIFT_SECONDS)
    data = gan_batch(kind, cfg, batch, seconds)
    b = _on(data, device)
    draws = gan_draws(kind, cfg, data, device)
    gen, disc, (gen_step, disc_step), g_state, d_state = gan_models(
        kind, cfg, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    halves, rows = [], []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def one():
        nonlocal g_state, d_state
        t0 = time.perf_counter()
        d_state, dm = disc_step(d_state, b, draws)
        sync()
        t1 = time.perf_counter()
        g_state, gm = gen_step(g_state, b, draws)
        m = {k: float(v) for k, v in {**dm, **gm}.items()}  # syncs
        halves.append((t1 - t0, time.perf_counter() - t1))
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"{kind} GAN iteration {g_state.step}: {m}")
        rows.append(m)

    reset_counts()
    one()
    for _ in range(iters):
        one()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    prof = profile_step(one, f"one {kind} GAN iteration") if on_card else {}
    seen = read_counts()
    if seen != ({"forward": 0, "backward": 0}, 0):
        raise AssertionError(f"{kind} GAN training launched (K2, K1) {seen}")
    disc_s = statistics.median(h[0] for h in halves[1: 1 + iters])
    gen_s = statistics.median(h[1] for h in halves[1: 1 + iters])
    audio_s = batch * data["audio"].shape[1] / 24000
    n_g = sum(p.numel() for p in gen.parameters())
    n_d = sum(p.numel() for p in disc.parameters())
    log(f"[gan] {card} | {kind} | generator {n_g} parameters, "
        f"discriminator {n_d} | batch {batch} x {data['audio'].shape[1]} "
        f"samples | median step_s disc {disc_s:.4f} gen {gen_s:.4f} "
        f"(iterations {[tuple(round(x, 4) for x in h) for h in halves]}) | "
        f"audio s/s {audio_s / (disc_s + gen_s):.1f} | peak memory "
        f"{peak / 2**30:.2f} GiB | K1, K2 launches 0 | first iteration "
        f"{ {k: round(v, 4) for k, v in rows[0].items()} }")
    return {"disc_step_s": disc_s, "gen_step_s": gen_s,
            "audio_s_per_s": audio_s / (disc_s + gen_s),
            "peak_gib": peak / 2**30, "profile": prof}


def reduced_gan(kind: str, cfg):
    """Phase 37's widths: the DAC at encoder 8, decoder 96, latent 16 (its
    rates kept) against 2 periods and one FFT; HiFT at 64 base channels
    and 32 f0 channels against 2 periods and 2 spectral discriminators."""
    if kind == "dac":
        return (dataclasses.replace(cfg, encoder_dim=8, decoder_dim=96,
                                    latent_dim=16),
                {"periods": (2, 3), "fft_sizes": (512,)})
    return (dataclasses.replace(cfg, base_channels=64, f0_cond_channels=32),
            {"periods": (2, 3), "fft_sizes": (512, 256),
             "hop_sizes": (120, 50), "win_lengths": (480, 240)})


@contextlib.contextmanager
def recorded_grads():
    """Every gradient list that train.steps.backward_and_update computes
    inside the block, on the CPU, in order."""
    from minimax_speech_torch.train import steps

    seen, orig = [], steps.backward_and_update

    def record(state, loss):
        grads = orig(state, loss)
        seen.append([g.detach().cpu() for g in grads])
        return grads

    steps.backward_and_update = record
    try:
        yield seen
    finally:
        steps.backward_and_update = orig


def gan_iteration(kind: str, cfg, disc_kw, data: dict, device, dtype):
    """One iteration (disc step, then gen step) of phase 37's models
    (seed 5) on `data` with the draws of seed 4, in `dtype` on `device`:
    (metrics, every leaf's gradient, the parameters after the step),
    keyed by "disc." / "gen." and the parameter's name, on the CPU."""
    import torch

    gen, disc, (gen_step, disc_step), g_state, d_state = gan_models(
        kind, cfg, device, seed=5, disc_kw=disc_kw, dtype=dtype)
    b = {k: v.to(dtype) for k, v in _on(data, device).items()}
    draws = gan_draws(kind, cfg, data, device, seed=4)
    draws = draws.to(dtype) if torch.is_tensor(draws) else type(draws)(
        draws.phase.to(dtype), draws.noise.to(dtype))
    with recorded_grads() as seen:
        d_state, dm = disc_step(d_state, b, draws)
        g_state, gm = gen_step(g_state, b, draws)
    names = [f"disc.{n}" for n, _ in disc.named_parameters()] + [
        f"gen.{n}" for n, _ in gen.named_parameters()]
    return ([{k: float(v) for k, v in {**dm, **gm}.items()}],
            dict(zip(names, seen[0] + seen[1])),
            {f"{tag}.{n}": p.detach().cpu() for tag, m in
             (("disc", disc), ("gen", gen)) for n, p in m.named_parameters()})


def gan_cross_check(kind: str, full_cfg, device="cuda"):
    """Phase 37's GAN half: one iteration at reduced width on `device`
    and on the CPU, the same weights, batch and draws. In float64, phase
    9's checks (compare_training) on the metrics, every leaf's gradient
    and the parameters after the step. In float32 (TF32 off), the
    metrics within TRAIN_METRIC_RTOL, and each leaf's gradient distance
    printed beside the CPU float32's own distance to float64 and beside
    the float64 gradient's move when the batch moves by GAN_NUDGE
    relative (see the comment above GAN_ITERS)."""
    import torch

    cfg, disc_kw = reduced_gan(kind, full_cfg)
    data = gan_batch(kind, cfg, GAN_CROSS_BATCH, GAN_CROSS_SECONDS, seed=3)
    runs = {dt: {dev: gan_iteration(kind, cfg, disc_kw, data, dev, dt)
                 for dev in ("cpu", device)}
            for dt in (torch.float64, torch.float32)}
    compare_training(runs[torch.float64], device, 1, f"cross-{kind}",
                     f"{kind} GAN iteration, reduced width, float64",
                     loss_key="gen/loss")
    (m_dev, g_dev, _), (m_cpu, g_cpu, _) = (runs[torch.float32][d]
                                            for d in (device, "cpu"))
    worst = max(abs(m_dev[0][k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu[0].items())
    truth = runs[torch.float64]["cpu"][1]
    rng = np.random.default_rng(37)
    nudged = {k: (v * (1 + GAN_NUDGE * rng.standard_normal(v.shape))).astype(
        v.dtype) if v.dtype == np.float32 and k != "pitch" else v
        for k, v in data.items()}
    moved = grad_errors(gan_iteration(kind, cfg, disc_kw, nudged, "cpu",
                                      torch.float64)[1], truth)
    card, cpu = (grad_errors(g, truth) for g in (g_dev, g_cpu))
    err = grad_errors(g_dev, g_cpu)
    w = sorted(err, key=lambda n: -err[n])[:3]
    log(f"[cross-{kind}] float32, TF32 off: worst metric rel diff "
        f"{worst:.2e} (tol {TRAIN_METRIC_RTOL:g}); "
        f"{sum(e > TRAIN_GRAD_RTOL for e in err.values())} of {len(err)} "
        f"leaves' gradients beyond {TRAIN_GRAD_RTOL:g} of their largest "
        f"card vs CPU, worst " + ", ".join(
            f"{n} {err[n]:.2e} (card / CPU to float64 {card[n]:.2e} / "
            f"{cpu[n]:.2e}; float64 moved {moved[n]:.2e} by the nudge)"
            for n in w) + f"; the nudge's largest move "
        f"{max(moved.values()):.2e} ({max(moved, key=moved.get)})")
    if worst > TRAIN_METRIC_RTOL:
        raise AssertionError(f"{kind} GAN iteration: float32 metrics differ "
                             f"card vs CPU by {worst:.2e}")


def v1_cross_check(device="cuda"):
    """Phase 37's S3 half: S3TokenizerV1 (25 Hz, default width, seed 0)
    over the whisper mel of V1_SECONDS of speech-like audio, its windows
    in one batch on `device` and on the CPU: codes identical, or each
    differing position a tie (top two distances on the CPU within
    V1_TIE_RTOL); quantize_long's merged tokens the same way."""
    import torch

    from minimax_speech_torch.models import s3tokenizer as s3
    from minimax_speech_torch.ops import mel as mel_ops
    from minimax_speech_torch.utils import params_io

    rng = np.random.default_rng(37)
    audio = speechlike(rng, int(V1_SECONDS * 16000), 16000)
    mel = mel_ops.whisper_log_mel(torch.as_tensor(audio)).T.numpy()
    wins = s3.split_windows(mel, mel.shape[0])
    batch = np.zeros((len(wins), s3.WINDOW_FRAMES, mel.shape[1]), np.float32)
    for i, w in enumerate(wins):
        batch[i, : len(w)] = w
    lens = torch.tensor([len(w) for w in wins])
    out = {}
    for dev in ("cpu", device):
        model = params_io.init_params(s3.S3TokenizerV1(),
                                      torch.Generator().manual_seed(0))
        model.to(dev).eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            hidden, code_len = model.encode(torch.as_tensor(batch).to(dev),
                                            lens.to(dev))
            codes = s3.nearest_code(hidden, model.codebook)
        out[dev] = (codes.cpu(), hidden.cpu(), code_len.cpu(),
                    time.perf_counter() - t0)
        book = model.codebook.detach().cpu()
    # quantize_long on the card; the CPU's codes merged as it merges them
    tokens = s3.quantize_long(model, mel, mel.shape[0])
    codes, hidden, code_len, secs = out[device]
    c_cpu, h_cpu, len_cpu, secs_cpu = out["cpu"]
    tok_cpu = s3.merge_window_tokens([c_cpu[i, :n].tolist() for i, n in
                                      enumerate(len_cpu.tolist())])
    valid = torch.arange(codes.shape[1])[None] < code_len[:, None]
    diff = (codes != c_cpu) & valid
    ties = 0
    for w, t in diff.nonzero().tolist():
        x = h_cpu[w, t].double()
        dist = (2 * book.double() @ x - book.double().square().sum(-1)
                - x.square().sum())
        top = torch.topk(dist, 2).values
        if abs(float(top[0] - top[1])) > V1_TIE_RTOL * abs(float(top[0])):
            raise AssertionError(f"S3 V1 window {w} frame {t}: code "
                                 f"{int(codes[w, t])} on the card, "
                                 f"{int(c_cpu[w, t])} on the CPU, top two "
                                 f"distances {top.tolist()}")
        ties += 1
    n_tok = sum(a != b for a, b in zip(tokens, tok_cpu))
    if not torch.equal(code_len, len_cpu) or len(tokens) != len(tok_cpu) \
            or n_tok > ties:
        raise AssertionError(f"S3 V1 quantize_long: {len(tokens)} vs "
                             f"{len(tok_cpu)} tokens, {n_tok} differ, "
                             f"{ties} ties")
    h_err = float((hidden - h_cpu).abs().max() / h_cpu.abs().max())
    log(f"[cross-s3v1] {V1_SECONDS:.0f} s, {len(wins)} windows, "
        f"{int(valid.sum())} codes: {int(diff.sum())} differ card vs CPU, "
        f"each a tie within {V1_TIE_RTOL:g} ({ties}); quantize_long "
        f"{len(tokens)} tokens, {n_tok} differ; encoder output max |diff| "
        f"{h_err:.2e} of its largest; the batched call card {secs:.2f} s, CPU "
        f"{secs_cpu:.2f} s")


def gan_cli_phase(card: str, device="cuda", config="configs/default.yaml",
                  dac_batch: int | None = None, hift_batch: int | None = None):
    """Phase 38: the CLIs on a written corpus (write_corpus, 16 wavs of
    8-16 s, plus one of 35 s): train_dac for 2 iterations at the CLI's
    batch (dac_batch), then a second call that resumes at step 2 for a
    third and writes --export_npz, which the port loads; train_hift
    --train_data --with_pitch the same way (hift_batch); extract_fsq v2
    (the 35 s file spans two windows) and v1_25hz at random weights;
    extract_dac_latents with the export (latent_stats.json beside it),
    extract_embedding, and eval_dac on the export, whose JSON is
    printed. K1 and K2 are never launched."""
    import shutil
    import tempfile
    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.cli import (eval_dac, extract_dac_latents,
                                          extract_embedding, extract_fsq,
                                          train_dac, train_hift)
    from minimax_speech_torch.models import dac_vae
    from minimax_speech_torch.utils import params_io

    repo = Path(__file__).resolve().parent
    scratch = repo / "build"
    scratch.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="gan_cli_", dir=scratch))
    cfg = str(repo / config)
    dev = ["--device", device, "--config", cfg]
    times = {}
    try:
        (root / "corpus").mkdir()
        lst = write_corpus(root / "corpus")
        rng = np.random.default_rng(38)
        import wave
        with wave.open(str(root / "corpus" / "long.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(24000)
            w.writeframes((speechlike(rng, 35 * 24000) * 32767).astype(
                np.int16).tobytes())
        reset_counts()

        def timed(name, fn, argv):
            t0 = time.perf_counter()
            fn(argv)
            times[name] = time.perf_counter() - t0

        dac_dir, npz = root / "dac", root / "dac" / "codec.npz"
        dac_args = ["--train_folders", str(root / "corpus"), "--model_dir",
                    str(dac_dir), "--log_interval", "1", "--warmup_steps",
                    "0"] + dev + (["--batch_size", str(dac_batch)]
                                  if dac_batch else [])
        timed("train_dac", train_dac.main, dac_args + ["--num_iters", "2"])
        timed("train_dac_resume", train_dac.main,
              dac_args + ["--num_iters", "3", "--export_npz", str(npz)])
        hift_dir = root / "hift"
        hift_args = ["--train_data", str(lst), "--with_pitch", "--model_dir",
                     str(hift_dir), "--log_interval", "1", "--warmup_steps",
                     "0"] + dev + (["--batch_size", str(hift_batch)]
                                   if hift_batch else [])
        timed("train_hift", train_hift.main, hift_args + ["--num_iters", "2"])
        timed("train_hift_resume", train_hift.main,
              hift_args + ["--num_iters", "3"])
        for d, name in ((dac_dir, "dac"), (hift_dir, "hift")):
            rows = [json.loads(x) for x in (d / f"{name}_metrics.jsonl")
                    .read_text().splitlines()]
            ckpts = sorted(p.name for p in (d / "ckpt_g").iterdir())
            if [r["step"] for r in rows] != [0, 1, 2] or ckpts != ["2", "3"] \
                    or not all(np.isfinite(v) for r in rows
                               for v in r.values()):
                raise AssertionError(f"{name} CLI: steps "
                                     f"{[r['step'] for r in rows]}, "
                                     f"checkpoints {ckpts}")
        codec = params_io.load_flax_params(
            dac_vae.DACVAE(cfg_lib.load_tts_config(cfg).dac),
            params_io.load_params(str(npz)))
        corpus = ["--dir", str(root / "corpus"), "--device", device]
        timed("extract_fsq_v2", extract_fsq.main,
              corpus + ["--random_init", "--config", cfg])
        toks = {p.stem: len(np.load(p)) for p in
                (root / "corpus").glob("*_fsq.npy")}
        if toks.get("long_fsq") != 875:
            raise AssertionError(f"extract_fsq v2: the 35 s file gave "
                                 f"{toks.get('long_fsq')} tokens, not 875")
        timed("extract_fsq_v1_25hz", extract_fsq.main,
              corpus + ["--random_init", "--model_version", "v1_25hz",
                        "--output_suffix", "_v1.npy"])
        timed("extract_dac_latents", extract_dac_latents.main,
              corpus + ["--ckpt", str(npz), "--config", cfg,
                        "--verify_fraction", "0.1"])
        stats = json.loads((dac_dir / "latent_stats.json").read_text())
        timed("extract_embedding", extract_embedding.main,
              corpus + ["--random_init"])
        n_spk = len(list((root / "corpus").glob("*_spk.npy")))
        t0 = time.perf_counter()
        metrics = eval_dac.main(["--ckpt", str(npz), "--wav_dir",
                                 str(root / "corpus"), "--max_files", "3",
                                 "--device", device, "--config", cfg])
        times["eval_dac"] = time.perf_counter() - t0
        seen = read_counts()
        if seen != ({"forward": 0, "backward": 0}, 0) or n_spk != 17 \
                or stats["frames"] == 0 or len(stats["mean"]) != 80:
            raise AssertionError(f"GAN/extraction CLIs: (K2, K1) {seen}, "
                                 f"{n_spk} embeddings, stats frames "
                                 f"{stats['frames']}")
        secs = json.dumps({k: round(v, 1) for k, v in times.items()})
        log(f"[cli-gan] {card} | seconds {secs} "
            f"| export {sum(p.numel() for p in codec.parameters())} "
            f"parameters loaded | v2 tokens of the 35 s file 875 (two "
            f"windows) | latent stats over {stats['frames']} frames | "
            f"{n_spk} embeddings | K1, K2 launches 0")
        log(f"[cli-gan] eval_dac {json.dumps(metrics)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return times


# ---------------------------------------------------------------- phase 39
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7, n = n & 0x7F, n >> 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _pb_field(num: int, payload) -> bytes:
    """A protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(payload, int):
        return _varint(num << 3) + _varint(payload)
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def write_onnx(path, state: dict) -> Path:
    """An .onnx file holding `state` ({name: float32 array}) as its
    graph's initializers, the part of a campplus.onnx that
    utils/onnx_reader.py reads: ModelProto.graph (7) ->
    GraphProto.initializer (5) -> TensorProto dims (1), data_type (2,
    1 = float32), name (8), raw_data (9)."""
    graph = b"".join(_pb_field(5, b"".join(
        [_pb_field(1, int(d)) for d in np.shape(a)]
        + [_pb_field(2, 1), _pb_field(8, k.encode()),
           _pb_field(9, np.ascontiguousarray(a, np.float32).tobytes())]))
        for k, a in state.items())
    path = Path(path)
    path.write_bytes(_pb_field(7, graph))
    return path


CAMPPLUS_PROMPT_SECONDS = (3.0, 6.5, 10.0)
FBANK_TOL = 1e-3       # log power, card vs CPU (cuFFT against pocketfft)
XVECTOR_RTOL = 1e-4    # of the embedding's largest value, card vs CPU
XVECTOR_TEXT = "Hello there, this is a test of the x-vector path."


def upstream_campplus_name(path: str, leaf: str) -> str:
    """The 3D-Speaker CAM++ state-dict name (what campplus.onnx and
    utils/convert.campplus_params hold) of the port's parameter `leaf` of
    module `path`."""
    bn = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
          "var": "running_var"}
    leaf = bn.get(leaf, leaf)
    p = re.sub(r"^head\.layer(\d)_(\d)", r"head.layer\1.\2", path)
    p = p.replace("shortcut_conv", "shortcut.0").replace(
        "shortcut_bn", "shortcut.1")
    p = re.sub(r"^block(\d+)_layer(\d+)\.(nonlinear\d)",
               r"xvector.block\1.tdnnd\2.\3.batchnorm", p)
    p = re.sub(r"^block(\d+)_layer(\d+)", r"xvector.block\1.tdnnd\2", p)
    p = re.sub(r"^transit(\d)_bn", r"xvector.transit\1.nonlinear.batchnorm",
               p)
    p = re.sub(r"^transit(\d)_linear", r"xvector.transit\1.linear", p)
    p = {"tdnn_linear": "xvector.tdnn.linear",
         "tdnn_bn": "xvector.tdnn.nonlinear.batchnorm",
         "out_bn": "xvector.out_nonlinear.batchnorm",
         "dense_linear": "xvector.dense.linear",
         "dense_bn": "xvector.dense.nonlinear.batchnorm"}.get(p, p)
    return f"{p}.{leaf}"


def campplus_state(seed: int = 39) -> dict:
    """Random weights of the default CAM++ under the upstream names: conv
    and dense weights at 1/sqrt(fan-in), batch norms with random
    statistics and affines (the dense head's without one, as upstream)."""
    from minimax_speech_torch.models.campplus import CAMPPlus

    rng = np.random.default_rng(seed)
    state = {}
    for path, mod in CAMPPlus().named_modules():
        for leaf, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if leaf == "weight":
                a = rng.standard_normal(shape) / math.sqrt(
                    math.prod(shape[1:]))
                if path == "dense_linear":  # a Conv1d of kernel 1 upstream
                    a = a[..., None]
            elif leaf == "mean":
                a = 0.1 * rng.standard_normal(shape)
            elif leaf == "var":
                a = 0.5 + rng.random(shape)
            elif path == "dense_bn":  # affine=False upstream
                continue
            else:  # bias, gamma, beta
                a = (leaf == "gamma") + 0.1 * rng.standard_normal(shape)
            state[upstream_campplus_name(path, leaf)] = a.astype(np.float32)
    return state


def write_tiktoken(path: Path) -> Path:
    """A .tiktoken asset: the 256 byte tokens and a few merges (each of
    two earlier tokens), as tests/test_textnorm.py builds it."""
    import base64

    ranks = {bytes([i]): i for i in range(256)}
    for m in (b"he", b"ll", b"llo", b"hello", b" t", b" th", b"th", b"is",
              b" is", b" w", b" wo", b"or", b"ld", b" world"):
        ranks[m] = len(ranks)
    path.write_text("".join(f"{base64.b64encode(t).decode()} {r}\n"
                            for t, r in ranks.items()))
    return path


def campplus_phase(card: str, device="cuda", config="configs/default.yaml",
                   lm_layers: int = PATH_LM_LAYERS,
                   max_tokens: int = 100) -> dict:
    """Phase 39: the default CAM++ from a written campplus.onnx (the
    reader exact at full size), the kaldi fbank and the embedding card vs
    CPU over CAMPPLUS_PROMPT_SECONDS prompts; TTS(model_dir=...) with
    that campplus.onnx and the flow's speaker encoder off at the widths
    of `config` (the LM at lm_layers): inference_zero_shot with K1's
    launches asserted per flow call; the synthesis CLI with a written
    .tiktoken. Returns {"launches": K1's per utterance}."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch.infer.api import TTS
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    from minimax_speech_torch.infer.whisper_tokenizer import (
        WhisperTikTokenizer, split_pieces)
    from minimax_speech_torch.models.campplus import load_campplus
    from minimax_speech_torch.ops.kaldi_fbank import kaldi_fbank
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.onnx_reader import read_onnx_initializers
    from minimax_speech_torch import config as cfg_lib

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="campplus_", dir=repo / "build"))
    try:
        state = campplus_state()
        onnx = write_onnx(root / "campplus.onnx", state)
        back = read_onnx_initializers(str(onnx))
        if back.keys() != state.keys() or any(
                not np.array_equal(back[k], v) for k, v in state.items()):
            raise AssertionError("campplus.onnx does not read back exactly")
        on_card, on_cpu = (load_campplus(str(onnx), device=d)
                           for d in (device, "cpu"))
        rng = np.random.default_rng(39)
        worst_fb, worst_xv, card_s, secs = 0.0, 0.0, 0.0, 0.0
        for sec in CAMPPLUS_PROMPT_SECONDS:
            audio = speechlike(rng, int(sec * 16000), 16000)
            feats, embs = [], []
            for model, dev in ((on_card, device), (on_cpu, "cpu")):
                x = torch.as_tensor(audio, device=dev)
                if dev == device:
                    sync(device)
                t0 = time.perf_counter()
                feat = kaldi_fbank(x)
                with torch.no_grad():
                    emb = model((feat - feat.mean(0, keepdim=True))[None])
                if dev == device:
                    sync(device)
                    card_s += time.perf_counter() - t0
                feats.append(feat.cpu().numpy())
                embs.append(emb.cpu().numpy())
            secs += sec
            worst_fb = max(worst_fb, float(np.abs(feats[0] - feats[1]).max()))
            worst_xv = max(worst_xv, float(np.abs(embs[0] - embs[1]).max()
                                           / np.abs(embs[1]).max()))
        log(f"[campplus] {card} | default CAM++ ({len(state)} tensors) from "
            f"campplus.onnx, read exactly; {len(CAMPPLUS_PROMPT_SECONDS)} "
            f"prompts {CAMPPLUS_PROMPT_SECONDS} s: fbank card vs CPU max "
            f"|diff| {worst_fb:.2e} (tol {FBANK_TOL:g}), x-vector "
            f"{worst_xv:.2e} of its largest (tol {XVECTOR_RTOL:g}); fbank + "
            f"CAM++ on the card {secs / card_s:.1f} audio-s per s "
            f"(first calls included)")
        if worst_fb > FBANK_TOL or worst_xv > XVECTOR_RTOL:
            raise AssertionError("CAM++ differs card vs CPU")

        d = root / "model"
        d.mkdir()
        (d / "config.yaml").write_text(  # CAM++'s 192-d x-vector in
            f"__base__: {repo / config}\nmodel:\n  max_speech_tokens: "
            f"{max_tokens}\n  lm:\n    spk_embed_dim: 192\n    qwen:\n"
            f"      n_layers: {lm_layers}\n  flow:\n    spk_embed_dim: 192\n"
            f"    use_speaker_encoder: false\n")
        cfg = cfg_lib.load_tts_config(d / "config.yaml")
        t0 = time.perf_counter()
        pipe = TTSPipeline.from_random(cfg, seed=0, device=device)
        for name, m in pipe.models().items():
            params_io.save_params(str(d / f"{'llm' if name == 'lm' else name}"
                                      ".npz"), m)
        del pipe
        shutil.copy(onnx, d / "campplus.onnx")
        tts = TTS(model_dir=str(d), device=device)
        load_s = time.perf_counter() - t0
        if tts._campplus is None or cfg.flow.use_speaker_encoder:
            raise AssertionError("the model_dir's campplus.onnx is unused")
        prompt = speechlike(rng, int(CAMPPLUS_PROMPT_SECONDS[0] * 16000),
                            16000)
        pieces = tts.frontend.text_normalize(XVECTOR_TEXT)
        expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps \
            * len(pieces)
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        wav = np.concatenate([o["tts_speech"] for o in tts.inference_zero_shot(
            XVECTOR_TEXT, "a reference", prompt)], axis=1)
        sync(device)
        total_s = time.perf_counter() - t0
        k2, k1 = read_counts()
        log(f"[campplus] {card} | TTS(model_dir) with campplus.onnx, "
            f"flow.use_speaker_encoder false, LM {lm_layers} layers: "
            f"written and loaded in {load_s:.1f} s; inference_zero_shot "
            f"{wav.shape[1] / 24000:.2f} s of audio in {total_s:.2f} s, "
            f"{len(pieces)} piece(s); K1 launches {k1} (expected {expect}), "
            f"K2 {k2}")
        if k1 != (expect if device == "cuda" else 0) or sum(k2.values()) \
                or wav.shape[1] == 0 \
                or not np.isfinite(wav).all():
            raise AssertionError(f"x-vector synthesis: K1 {k1}, {wav.shape}")
        del tts

        # the synthesis CLI on the tokenizer's standard-library path, with
        # tiktoken and regex hidden from the import system
        asset = write_tiktoken(root / "tiny.tiktoken")
        text = "Hello there, this is a test."
        first = WhisperTikTokenizer(str(asset))
        hidden = {m: sys.modules.get(m) for m in ("tiktoken", "regex")}
        sys.modules.update(dict.fromkeys(hidden))
        try:
            tok = WhisperTikTokenizer(str(asset))
            if tok._enc is not None or tok._split is not split_pieces:
                raise AssertionError("the stdlib BPE path was not taken")
            if tok.encode(text) != first.encode(text):
                raise AssertionError("the stdlib BPE differs from the "
                                     "first path that imports")
            log(f"[campplus] {text!r} through the stdlib BPE: "
                f"{len(tok.encode(text))} ids, as the "
                f"{'tiktoken' if first._enc is not None else 'regex'} "
                f"path gives them")
            synth_cli_phase(config, device=device, streams=(False,),
                            tokenizer=str(asset))
        finally:
            for m, mod in hidden.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod
        return {"launches": expect // len(pieces)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


CODEC_SECONDS, CODEC_WIN, CODEC_OVERLAP = 60.0, 5.0, 24000


def codec_phase(card: str, device="cuda", seconds: float = CODEC_SECONDS,
                cpu_windows: int = 2) -> dict:
    """Phase 40: cli/codec.py compress then decompress of `seconds` of
    speech-like 24 kHz audio at the default DAC-VAE (seed 0), CODEC_WIN s
    windows with CODEC_OVERLAP samples of overlap, each direction's
    audio seconds per second; the artifact's chunked mu against one
    full-signal encode of the same normalised signal on the card (the
    interior, JAX's test's limits); the first cpu_windows windows
    decompressed card vs CPU (PCM within PCM_TOL_LSB); K1 = K2 = 0."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch.cli import codec as codec_cli
    from minimax_speech_torch.cli.synthesize import write_wav
    from minimax_speech_torch.data.pipeline import _load_audio
    from minimax_speech_torch.infer.codec_file import (DACVAECodec,
                                                       DACVAEFile,
                                                       loudness_db)
    from minimax_speech_torch.models import dac_vae
    from minimax_speech_torch.utils import params_io

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="codec_", dir=repo / "build"))
    try:
        audio = speechlike(np.random.default_rng(40), int(seconds * 24000))
        write_wav(str(root / "speech.wav"), audio, 24000)
        args = ["--win", str(CODEC_WIN), "--overlap", str(CODEC_OVERLAP),
                "--device", device]
        reset_counts()
        t0 = time.perf_counter()
        (dacz,) = codec_cli.main(["compress", "--inputs",
                                  str(root / "speech.wav"), *args])
        comp_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (wav,) = codec_cli.main(["decompress", "--inputs", str(dacz),
                                 "--out_dir", str(root), *args])
        dec_s = time.perf_counter() - t0
        k2, k1 = read_counts()

        def seed0(dev):
            m = params_io.init_params(dac_vae.DACVAE(dac_vae.DACVAEConfig()),
                                      torch.Generator().manual_seed(0))
            return DACVAECodec(m.to(dev), win_duration=CODEC_WIN,
                               overlap=CODEC_OVERLAP)

        card_codec = seed0(device)
        art = DACVAEFile.load(dacz)
        x, _ = _load_audio(str(root / "speech.wav"))
        x = x * (10.0 ** ((-16.0 - loudness_db(x)) / 20.0))
        x = x / max(float(np.abs(x).max()), 1.0)
        full = card_codec.encode_mu(dac_vae.pad_to_hop(x, card_codec.hop))
        edge = card_codec.ov_lat // 2
        chunked = art.latents.astype(np.float32)
        ok = np.allclose(chunked[edge:-edge], full[edge:-edge], atol=5e-3,
                         rtol=5e-2)
        mu_diff = float(np.abs(chunked[edge:-edge] - full[edge:-edge]).max())
        short = DACVAEFile(latents=art.latents[: cpu_windows
                                               * card_codec.win_lat],
                           original_length=cpu_windows * card_codec.win,
                           input_db=art.input_db, sample_rate=24000,
                           chunk_length=art.chunk_length)
        pcm = [np.round(np.clip(c.decompress(short), -1, 1) * 32767)
               for c in (card_codec, seed0("cpu"))]
        lsb = int(np.abs(pcm[0] - pcm[1]).max())
        out, sr = _load_audio(str(wav))
        log(f"[codec] {card} | cli/codec.py at the default DAC-VAE, "
            f"{seconds:.0f} s at 24 kHz, {CODEC_WIN:g} s windows, "
            f"{CODEC_OVERLAP} samples of overlap: compress {comp_s:.2f} s "
            f"({seconds / comp_s:.1f} audio-s per s), {art.latents.shape} "
            f"float16 latents; decompress {dec_s:.2f} s ({seconds / dec_s:.1f}"
            f" audio-s per s), {len(out)} samples at {sr} Hz; chunked mu vs "
            f"full-signal encode (interior) max |diff| {mu_diff:.2e}; "
            f"{cpu_windows} windows decompressed card vs CPU max |diff| "
            f"{lsb} LSB (tol {PCM_TOL_LSB}); K1 {k1}, K2 {k2}")
        if not ok or lsb > PCM_TOL_LSB or k1 or sum(k2.values()) \
                or len(out) != len(audio) or not np.isfinite(out).all():
            raise AssertionError("the codec file phase failed")
        return {"compress_audio_s_per_s": seconds / comp_s,
                "decompress_audio_s_per_s": seconds / dec_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# every transform that calls an AudioSignal method, at its defaults: the
# chain of phase 41 (and its CLI run's --augment). The quantizers come
# first, on the same input on both devices: later, float noise of a few
# ulps decides which level a sample near a level's edge takes (with 8
# levels the edge is at 0, where masked and denoised audio lies), a step
# of 2/q. The two that threshold an FFT magnitude come last.
TRANSFORM_CHAIN = [
    "Quantization", "MuLawQuantization", "ClippingDistortion",
    "VolumeChange", "ShiftPhase", "Equalizer", "LowPass", "HighPass",
    "Smoothing", "BackgroundNoise", "RoomImpulseResponse", "NoiseFloor",
    "CrossTalk", "CorruptPhase", "FrequencyMask", "TimeMask", "TimeNoise",
    "FrequencyNoise", "MaskLowMagnitudes", "SpectralDenoising"]
TRANSFORM_RTOL = 1e-4    # of the batch's peak, card vs CPU per sample
# a quantizer rounds a value at a level's edge to the next level where
# float32 log1p/exp differ by an ulp between the devices: the share of
# such samples allowed
TRANSFORM_FLIP_SHARE = 1e-3
# MaskLowMagnitudes and SpectralDenoising compare an STFT magnitude in dB
# with a threshold: a bin within cuFFT's and pocketfft's rounding of it is
# kept on one device and masked on the other (on an NVIDIA H100 80GB
# HBM3, with another draw order: 0.4% and 0.04% of the samples moved, by
# at most 5.8e-4 and 1.5e-4 of the peak); they, and the whole chain, are
# held to this share of the peak per sample, the chain's mean |diff| to
# TRANSFORM_RTOL
THRESHOLD_RTOL = 1e-2
THRESHOLDING = ("MaskLowMagnitudes", "SpectralDenoising")


def transforms_phase(card: str, device="cuda", batch: int = DAC_BATCH,
                     cli_batch: int | None = None,
                     config="configs/default.yaml") -> dict:
    """Phase 41: build_transform(VolumeNorm | TRANSFORM_CHAIN |
    RescaleAudio) on phase 35's batch (batch x 9120 samples) with one set
    of draws (a CPU generator) applied on the card and on the CPU: each
    stage alone on the same input, its samples within TRANSFORM_RTOL of
    the peak (the quantizers': all but TRANSFORM_FLIP_SHARE of them; the
    thresholding stages' within THRESHOLD_RTOL), then the whole chain
    (within THRESHOLD_RTOL, its mean |diff| within TRANSFORM_RTOL); then
    cli/train_dac.py for 2 iterations with that chain at --augment_prob
    0.5. K1 = K2 = 0."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch.cli import train_dac
    from minimax_speech_torch.utils.audio_signal import AudioSignal
    from minimax_speech_torch.utils.audio_transforms import build_transform

    rng = np.random.default_rng(41)
    n = int(DAC_SECONDS * 24000) // 480 * 480
    audio = np.stack([speechlike(rng, n) for _ in range(batch)])[:, None]
    tfm = build_transform(1.0, preprocess=["VolumeNorm"],
                          augment=TRANSFORM_CHAIN,
                          postprocess=["RescaleAudio"])
    sigs = {d: AudioSignal(audio, 24000, device=d) for d in (device, "cpu")}
    draws = tfm.draw(torch.Generator().manual_seed(41), sigs["cpu"])
    stages = [(t, d) for comp, cd in zip(tfm.transforms, draws["tfm"]["each"])
              for t, d in zip(comp.transforms, cd["tfm"]["each"])]
    reset_counts()
    report, bad = [], []
    for t, d in stages + [(tfm, draws)]:
        outs = {}
        for dev, sig in sigs.items():
            sync(device)
            t0 = time.perf_counter()
            out = t.apply(d, sig).audio_data
            sync(device)
            outs[dev] = (out.cpu().numpy(), time.perf_counter() - t0)
        ref, ours = outs["cpu"][0], outs[device][0]
        diff = np.abs(ours - ref)
        peak = max(float(np.abs(ref).max()), 1e-12)
        share = float((diff > TRANSFORM_RTOL * peak).mean())
        name = t.name if t is not tfm else "the whole chain"
        report.append(f"{name} {diff.max() / peak:.1e}/{share:.1e}"
                      + (f" (mean {diff.mean() / peak:.1e})" if t is tfm
                         else "")
                      + f" {outs[device][1] * 1e3:.0f}/"
                        f"{outs['cpu'][1] * 1e3:.0f} ms")
        if t is tfm:
            ok = diff.mean() <= TRANSFORM_RTOL * peak \
                and diff.max() <= THRESHOLD_RTOL * peak
        elif name in THRESHOLDING:
            ok = diff.max() <= THRESHOLD_RTOL * peak
        else:
            ok = share <= (TRANSFORM_FLIP_SHARE if "Quantization" in name
                           else 0.0)
        if not ok or not np.isfinite(ours).all():
            bad.append(name)
    k2, k1 = read_counts()
    log(f"[transforms] {card} | {batch} x {n} samples, card vs CPU with one "
        f"set of draws: per stage max |diff| / peak, share beyond "
        f"{TRANSFORM_RTOL:g} of the peak, card / CPU ms: "
        + "; ".join(report) + f"; K1 {k1}, K2 {k2}")
    if bad or k1 or sum(k2.values()):
        raise AssertionError(f"transforms differ card vs CPU: {bad}")

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="transforms_", dir=repo / "build"))
    try:
        (root / "corpus").mkdir()
        write_corpus(root / "corpus", n=4)
        reset_counts()
        t0 = time.perf_counter()
        train_dac.main([
            "--train_folders", str(root / "corpus"), "--model_dir",
            str(root / "dac"), "--config", str(repo / config), "--device",
            device, "--num_iters", "2", "--log_interval", "1",
            "--warmup_steps", "0", "--preprocess", "VolumeNorm",
            "--augment", *TRANSFORM_CHAIN, "--postprocess", "RescaleAudio",
            "--augment_prob", "0.5"]
            + (["--batch_size", str(cli_batch)] if cli_batch else []))
        cli_s = time.perf_counter() - t0
        k2, k1 = read_counts()
        rows = [json.loads(line) for line in
                (root / "dac" / "dac_metrics.jsonl").read_text().splitlines()]
        log(f"[transforms] {card} | cli/train_dac.py 2 iterations with the "
            f"chain at --augment_prob 0.5: {cli_s:.1f} s; losses "
            f"{[round(r.get('gen/loss', float('nan')), 4) for r in rows]}; "
            f"K1 {k1}, K2 {k2}")
        if k1 or sum(k2.values()) or [r["step"] for r in rows] != [0, 1] \
                or not all(np.isfinite(v) for r in rows for v in r.values()
                           if isinstance(v, float)):
            raise AssertionError("train_dac with transforms failed")
        return {"cli_s": cli_s}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Matcha-TTS and the legacy CosyVoice1 flow and LM: phases 42-44
MATCHA_TEXTS = ["Hello there, this is a test of the Matcha voice.",
                "The quick brown fox jumps over the lazy dog.",
                "One more sentence, to fill the batch."]
MEL_RTOL = 1e-4     # of the mel's peak, card vs CPU (Matcha and legacy)
MATCHA_TRAIN_SEED = 43


def matcha_phase(card: str, device="cuda", hidden: int = 192,
                 n_layers: int = 6, max_frames: int = 1000,
                 steps: int = 10, texts=MATCHA_TEXTS) -> dict:
    """Phase 42: cli/matcha.py --random_init at `hidden` / `n_layers`
    (the default UNet and HiFi-GAN V1) over `texts`, unbatched (one
    synthesis call per text) and --batched (one call): K1 launches per
    call (40 with 10 steps) and K2 0 asserted, RTF, the acoustic model's,
    HiFi-GAN's and the denoiser's seconds, peak memory; then the first
    text's mel against the same weights and z on the CPU within
    MEL_RTOL of its peak, frame lengths equal; K1 at the synthesis shapes
    (3 and 1, 4, max_frames, 64) with the calls' key lengths against its
    plain version and timed. Returns the record."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch.cli import matcha as matcha_cli
    from minimax_speech_torch.models import matcha as m
    from minimax_speech_torch.utils import params_io

    on_card = device == "cuda"
    cfg = m.MatchaConfig(hidden=hidden, n_layers=n_layers)
    # one K1 launch per UNet block per Euler step
    per_call = attn_calls_per_step(cfg.unet) * steps if on_card else 0
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="matcha_", dir=repo / "build"))
    rec = {"launches": {}}
    try:
        (root / "texts.txt").write_text("\n".join(texts))
        base = ["--file", str(root / "texts.txt"), "--random_init",
                "--hidden", str(hidden), "--n_layers", str(n_layers),
                "--max_frames", str(max_frames), "--steps", str(steps),
                "--device", device]
        for mode, extra, calls in (("unbatched", [], len(texts)),
                                   ("batched", ["--batched"], 1)):
            out = root / mode
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            summary = matcha_cli.main(base + extra
                                      + ["--output_folder", str(out)])
            k2, k1 = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30 if on_card \
                else 0.0
            mels = [np.load(out / f"utterance_{i:03d}_mel.npy")
                    for i in range(len(texts))]
            wavs = [out / f"utterance_{i:03d}.wav" for i in range(len(texts))]
            log(f"[matcha] {card} | cli/matcha.py {mode}, hidden {hidden}, "
                f"{n_layers} layers, {steps} steps, max_frames {max_frames}: "
                f"{len(texts)} utterances of {[x.shape[0] for x in mels]} "
                f"frames | rtf_mean {summary['rtf_mean']:.4f}, wall "
                f"{summary['wall']} s, acoustic {summary['acoustic_s']} s, "
                f"HiFi-GAN {summary['vocoder_s']} s, denoiser "
                f"{summary['denoiser_s']} s | peak memory {peak:.2f} GiB | "
                f"K1 {k1} launches ({k1 / calls:g} per call, expected "
                f"{per_call}), K2 {k2}")
            if k1 != per_call * calls or sum(k2.values()) \
                    or summary["n"] != len(texts) \
                    or not all(w.stat().st_size > 44 for w in wavs) \
                    or not all(np.isfinite(x).all() and x.shape[0] > 0
                               for x in mels):
                raise AssertionError(f"the Matcha CLI ({mode}) failed")
            rec["launches"][f"matcha_cli_{mode}"] = k1
            rec[mode] = {**summary, "peak_gib": peak, "frames":
                         [x.shape[0] for x in mels]}
        # the first text on the CPU: the CLI's weights (seed 0) and z
        # (the host generator at seed 0), its unbatched bucket
        from minimax_speech_torch.infer.matcha_text import process_text
        seq, _ = process_text(texts[0], ("english_cleaners2",))
        tokens = np.zeros((1, matcha_cli._bucket(len(seq))), np.int64)
        tokens[0, :len(seq)] = seq
        z = torch.randn((1, max_frames, cfg.n_feats),
                        generator=torch.Generator().manual_seed(0))
        model = params_io.init_params(m.MatchaTTS(cfg),
                                      torch.Generator().manual_seed(0))
        ref, ref_len = m.matcha_synthesise(
            model, tokens, [len(seq)], z=z, n_timesteps=steps,
            length_scale=0.95, max_frames=max_frames, device="cpu")
        n = int(ref_len[0])
        ref = ref[0, :n].numpy()
        got = np.load(root / "unbatched" / "utterance_000_mel.npy")
        err = float(np.abs(got - ref).max()) if got.shape == ref.shape \
            else float("inf")
        log(f"[matcha] card vs CPU, utterance 0: frames {got.shape[0]} vs "
            f"{n}, mel max |diff| {err:.2e} of peak {np.abs(ref).max():.3f} "
            f"(tol {MEL_RTOL:g} of the peak)")
        if err > MEL_RTOL * float(np.abs(ref).max()):
            raise AssertionError("Matcha's mel differs card vs CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if on_card:  # K1 at the batched call's shape, then one text's
        u = cfg.unet
        kv = rec["batched"]["frames"]
        gen = torch.Generator(device="cuda").manual_seed(42)
        rec["k1"] = {}
        for name, lens in (("matcha_batched", kv), ("matcha_unbatched",
                                                    kv[:1])):
            shape = (len(lens), u.num_heads, max_frames,
                     u.attention_head_dim)
            k1_agreement([(shape, lens)], {"full": {}}, gen)
            rec["k1"][name] = k1_timing(gen, shape, lens)
    return rec


def matcha_corpus(root: Path, n: int = 8, seed: int = MATCHA_TRAIN_SEED):
    """n speech-like 22.05 kHz wavs of 1.5-3 s with a text each, and
    their list file."""
    from minimax_speech_torch.cli.synthesize import write_wav

    rng = np.random.default_rng(seed)
    words = "the of and to in is that it was for on are with as his".split()
    paths = []
    for i in range(n):
        w = root / f"m{i}.wav"
        write_wav(str(w), speechlike(rng, int(rng.uniform(1.5, 3.0)
                                               * 22050), 22050), 22050)
        w.with_suffix(".txt").write_text(" ".join(
            rng.choice(words, int(rng.integers(6, 14)))))
        paths.append(str(w))
    lst = root / "data.list"
    lst.write_text("\n".join(paths))
    return lst


def matcha_train_phase(card: str, device="cuda", n_utts: int = 8,
                       epochs: int = 3) -> dict:
    """Phase 43: cli/train_matcha.py at MatchaConfig() on a written corpus
    of n_utts wav/txt pairs (one batch of n_utts a step) for `epochs`
    steps, each launching K2 4 + 4 (one per UNet block) and K1 never; the
    metrics rows finite. Then, on the same batch and draws, the first
    step's three losses and every leaf's gradient card vs CPU (the MAS
    path identical), the step's time and MAS's (maximum_path on the
    step's logp shape, CUDA events) beside it, and K2 at the step's shape
    (8, 4, mel bucket, 64) with its mel lengths against its plain
    version and timed. Returns the record."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch.cli import train_matcha as tm_cli
    from minimax_speech_torch.models import cfm
    from minimax_speech_torch.models import matcha as m
    from minimax_speech_torch.ops import monotonic_align as ma
    from minimax_speech_torch.utils import params_io

    on_card = device == "cuda"
    cfg = m.MatchaConfig()
    per_step = attn_calls_per_step(cfg.unet) if on_card else 0
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="matcha_train_", dir=repo / "build"))
    try:
        lst = matcha_corpus(root, n_utts)
        reset_counts()
        t0 = time.perf_counter()
        n_steps = tm_cli.main([
            "--train_data", str(lst), "--model_dir", str(root / "exp"),
            "--num_epochs", str(epochs), "--batch_size", str(n_utts),
            "--log_interval", "1", "--cleaners", "english_cleaners2",
            "--device", device])
        cli_s = time.perf_counter() - t0
        k2, k1 = read_counts()
        rows = [json.loads(r) for r in (root / "exp" / "matcha_metrics.jsonl")
                .read_text().splitlines()]
        log(f"[matcha-train] {card} | cli/train_matcha.py, {n_utts} "
            f"utterances, {n_steps} steps in {cli_s:.1f} s (corpus mels "
            f"included): loss {[round(r['loss'], 4) for r in rows]} | K2 "
            f"{k2}, K1 {k1} (expected {per_step} + {per_step} per step)")
        if k2 != {"forward": per_step * n_steps,
                  "backward": per_step * n_steps} or k1 \
                or len(rows) != n_steps \
                or not all(np.isfinite(r["loss"]) for r in rows):
            raise AssertionError("the Matcha training CLI failed")
        items = tm_cli.load_corpus(str(lst), ("english_cleaners2",))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the CLI's first batch, normalised as it normalises it
    allm = np.concatenate([x for _, x in items])
    mean, std = float(allm.mean()), float(allm.std())
    tok_pad = tm_cli._bucket(max(len(t) for t, _ in items))
    mel_pad = tm_cli._bucket(max(x.shape[0] for _, x in items))
    tokens = np.zeros((n_utts, tok_pad), np.int64)
    mels = np.zeros((n_utts, mel_pad, cfg.n_feats), np.float32)
    for j, (t, x) in enumerate(items):
        tokens[j, :len(t)] = t
        mels[j, :x.shape[0]] = (x - mean) / std
    lens = (torch.tensor([len(t) for t, _ in items]),
            torch.tensor([x.shape[0] for _, x in items]))
    draws = cfm.make_draws(cfg.cfm, n_utts, mel_pad, cfg.n_feats,
                           torch.Generator().manual_seed(0))
    runs = {}
    for label, dev in (("cpu", "cpu"), ("card", device), ("nudged", "cpu")):
        model = params_io.init_params(m.MatchaTTS(cfg),
                                      torch.Generator().manual_seed(0))
        if label == "nudged":  # the text encoder's input moved by GAN_NUDGE
            with torch.no_grad():
                emb = model.encoder.emb.weight
                emb.mul_(1 + GAN_NUDGE * torch.randn(
                    emb.shape, generator=torch.Generator().manual_seed(1)))
        model.to(dev)
        batch = (torch.as_tensor(tokens, device=dev), lens[0].to(dev),
                 torch.as_tensor(mels, device=dev), lens[1].to(dev))
        d = dataclasses.replace(draws, t=draws.t.to(dev),
                                cand=draws.cand.to(dev))
        paths = []
        orig = ma.maximum_path
        ma.maximum_path = lambda v, k: paths.append(orig(v, k)) or paths[-1]
        try:
            reset_counts()
            losses = model(*batch, d)
            grads = torch.autograd.grad(sum(losses),
                                        list(model.parameters()))
            seen = read_counts()
        finally:
            ma.maximum_path = orig
        runs[label] = ([float(x.detach()) for x in losses],
                       {n: g.cpu() for (n, _), g in
                        zip(model.named_parameters(), grads)},
                       paths[0].cpu(), seen, model, batch, d)
    l_dev, g_dev, p_dev, seen, model, batch, d = runs["card"]
    l_cpu, g_cpu, p_cpu = runs["cpu"][:3]
    loss_err = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(l_dev, l_cpu))
    # the decoder's leaves (the UNet, K2 under grad) are held; the text
    # encoder's sit behind ReLUs (FFNs, prenet, duration predictor), where
    # float32 rounding flips a gate and the gradient jumps, as a GAN_NUDGE
    # move of the encoder's input shows on the CPU alone: printed, not
    # held (phase 37's leaky ReLUs likewise)
    grad_err = grad_errors(g_dev, g_cpu)
    held = [n for n in g_cpu if n.startswith("decoder.")]
    worst = max(held, key=grad_err.get)
    enc = sorted((n for n in g_cpu if n not in held),
                 key=lambda n: -grad_err[n])[:3]
    moved = grad_errors(runs["nudged"][1], g_cpu)
    same_path = bool(torch.equal(p_dev, p_cpu))
    log(f"[matcha-train] first step card vs CPU, batch {n_utts} x "
        f"{mel_pad} frames: (dur, prior, cfm) {[round(x, 5) for x in l_dev]}"
        f" vs {[round(x, 5) for x in l_cpu]}, worst rel diff "
        f"{loss_err:.2e} (tol {TRAIN_METRIC_RTOL:g}); MAS path identical "
        f"{same_path}; the decoder's {len(held)} leaves: worst gradient "
        f"{grad_err[worst]:.2e} of its largest ({worst}; tol "
        f"{TRAIN_GRAD_RTOL:g}); the encoder's worst (not held) " + ", ".join(
            f"{n} {grad_err[n]:.2e} (the CPU's own move under the nudge "
            f"{moved[n]:.2e})" for n in enc) + f", the nudge's largest move "
        f"{max(moved.values()):.2e}; K2 {seen[0]}, K1 {seen[1]}")
    if loss_err > TRAIN_METRIC_RTOL or grad_err[worst] > TRAIN_GRAD_RTOL \
            or not same_path or seen != ({"forward": per_step,
                                          "backward": per_step}, 0):
        raise AssertionError("Matcha's training step differs card vs CPU")
    rec = {"launches": {"matcha_train_cli": sum(k2.values())},
           "per_step": {"forward": per_step, "backward": per_step}}
    if not on_card:
        return rec

    # the step's time and MAS's share of it, on the card
    from minimax_speech_torch.train import schedule, steps
    state = steps.make_train_state(model, schedule.make_optimizer(
        lr=1e-4, warmup_steps=0))
    step = steps.make_matcha_train_step(model, device=device)
    tb = {"tokens": batch[0], "token_len": batch[1], "mels": batch[2],
          "mel_len": batch[3]}
    secs = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mt = step(state, tb, d)
        float(mt["loss"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = 1e3 * statistics.median(secs[1:])
    logp = torch.randn((n_utts, tok_pad, mel_pad), device="cuda")
    x_mask = torch.arange(tok_pad, device="cuda")[None] < batch[1][:, None]
    y_mask = torch.arange(mel_pad, device="cuda")[None] < batch[3][:, None]
    amask = x_mask[:, :, None] & y_mask[:, None, :]
    mas_ms = cuda_ms(lambda: ma.maximum_path(logp, amask), iters=5)
    log(f"[matcha-train] {card} | a train step at B {n_utts}, tokens "
        f"{tok_pad}, {mel_pad} mel frames: median {step_ms:.1f} ms (steps "
        f"{[round(1e3 * s, 1) for s in secs[1:]]}); MAS (maximum_path, "
        f"{mel_pad} frames forward and back) {mas_ms:.1f} ms, "
        f"{mas_ms / step_ms:.3f} of the step")
    u = cfg.unet
    kv = [int(n) for n in batch[3]]
    shape = (n_utts, u.num_heads, mel_pad, u.attention_head_dim)
    gen = torch.Generator(device="cuda").manual_seed(43)
    k2_agreement([(shape, kv)], {"full": K2_MODES["full"]}, gen)
    rec.update(step_ms=step_ms, mas_ms=mas_ms, k2=k2_timing(gen, shape, kv,
                                                            "full"))
    return rec


LEGACY_TOKENS, LEGACY_PROMPT_TOKENS, LEGACY_PROMPT_FRAMES = 250, 50, 86


def legacy_inputs(cfg, seed: int = 44):
    """A prompt of LEGACY_PROMPT_TOKENS tokens and LEGACY_PROMPT_FRAMES
    mel frames (1 s) and LEGACY_TOKENS new tokens (5 s), an x-vector and
    the start noise."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (1, LEGACY_TOKENS)),
            [LEGACY_TOKENS],
            rng.integers(0, cfg.vocab_size, (1, LEGACY_PROMPT_TOKENS)),
            [LEGACY_PROMPT_TOKENS],
            rng.standard_normal((1, LEGACY_PROMPT_FRAMES, cfg.output_size))
            .astype(np.float32),
            rng.standard_normal((1, cfg.spk_embed_dim)).astype(np.float32),
            rng.standard_normal((1, 1024, cfg.output_size))
            .astype(np.float32))


def legacy_phase(card: str, device="cuda", cpu_steps: int = 2,
                 loss_batch: int = 2, lm_batch_n: int = 4) -> dict:
    """Phase 44: the legacy CosyVoice1 flow at LegacyFlowConfig() (random
    weights, seed 0): legacy_flow_inference with a 1 s prompt and 5 s of
    new tokens, 10 CFG steps, timed, K1 640 launches (64 blocks x 10) and
    K2 0 asserted; the same call at cpu_steps steps card vs CPU (mel
    within MEL_RTOL of its peak); one training loss backward on
    loss_batch utterances (K2 64 + 64, K1 0), loss and every leaf's
    gradient card vs CPU at phase 9's limits; K1 at the inference shapes
    (2, 8, T, 64) and (2, 8, ceil(T/2), 64) and K2 at the loss's against
    their plain versions and timed; then the legacy LM at
    LegacyLMConfig(): one loss and accuracy forward and backward on
    lm_batch_n plans, card vs CPU. Returns the record."""
    import torch

    from minimax_speech_torch.models import legacy_flow as lf
    from minimax_speech_torch.models import legacy_lm as llm
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.utils import params_io

    on_card = device == "cuda"
    cfg = lf.LegacyFlowConfig()
    blocks = attn_calls_per_step(cfg.unet)
    inputs = legacy_inputs(cfg)
    models = {dev: params_io.init_params(
        lf.MaskedDiffWithXvec(cfg), torch.Generator().manual_seed(0)).to(dev)
        for dev in ("cpu", device)}
    model = models[device]
    lf.legacy_flow_inference(model, *inputs, device=device)  # warm-up
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    mel = lf.legacy_flow_inference(model, *inputs, device=device)
    sync(device)
    infer_s = time.perf_counter() - t0
    k2, k1 = read_counts()
    expect = blocks * cfg.n_timesteps if on_card else 0
    total = LEGACY_PROMPT_FRAMES + mel.shape[1]
    log(f"[legacy] {card} | legacy_flow_inference at LegacyFlowConfig(), "
        f"prompt {LEGACY_PROMPT_TOKENS} tokens / {LEGACY_PROMPT_FRAMES} "
        f"frames, {LEGACY_TOKENS} new tokens -> {mel.shape[1]} mel frames "
        f"(UNet T {total} and {(total + 1) // 2}, CFG batch 2), "
        f"{cfg.n_timesteps} steps in {infer_s:.3f} s ({mel.shape[1] * 256 / 22050:.2f} "
        f"audio-s) | K1 {k1} (expected {expect}), K2 {k2}")
    if k1 != expect or sum(k2.values()) \
            or not torch.isfinite(mel).all():
        raise AssertionError("legacy flow inference failed")
    mels = {dev: lf.legacy_flow_inference(models[dev], *inputs,
                                          n_timesteps=cpu_steps,
                                          device=dev).cpu()
            for dev in ("cpu", device)}
    err = float((mels[device] - mels["cpu"]).abs().max())
    peak = float(mels["cpu"].abs().max())
    log(f"[legacy] {cpu_steps}-step mel card vs CPU max |diff| {err:.2e} of "
        f"peak {peak:.3f} (tol {MEL_RTOL:g} of the peak)")
    if err > MEL_RTOL * peak:
        raise AssertionError("the legacy mel differs card vs CPU")

    # one training loss backward, card vs CPU
    rng = np.random.default_rng(45)
    t_tok = [200, 150][:loss_batch] + [120] * max(0, loss_batch - 2)
    tf = [int(n / cfg.input_frame_rate * cfg.mel_rate) for n in t_tok]
    batch = (torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (loss_batch, max(t_tok)))),
             torch.tensor(t_tok),
             torch.as_tensor(rng.standard_normal(
                 (loss_batch, max(tf), cfg.output_size)), dtype=torch.float32),
             torch.tensor(tf),
             torch.as_tensor(rng.standard_normal(
                 (loss_batch, cfg.spk_embed_dim)), dtype=torch.float32))
    draws = lf.make_legacy_draws(cfg, loss_batch, max(tf),
                                 torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", device):
        d = lf.FlowDraws(draws.use_cond.to(dev), draws.frac.to(dev),
                         dataclasses.replace(draws.cfm, **{
                             f: getattr(draws.cfm, f).to(dev)
                             for f in ("t", "cand", "keep", "perm")}))
        reset_counts()
        t0 = time.perf_counter()
        loss = models[dev](*(a.to(dev) for a in batch), d)
        named = list(models[dev].named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        sync(dev)
        runs[dev] = (float(loss.detach()), {n: g.cpu() for (n, _), g in
                                   zip(named, grads)}, read_counts(),
                     time.perf_counter() - t0)
    symmetric = [n for n in runs["cpu"][1] if n.endswith("linear_k.bias")]
    grad_err = grad_errors(runs[device][1], runs["cpu"][1], symmetric)
    worst = max(grad_err, key=grad_err.get)
    loss_err = abs(runs[device][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    want = ({"forward": blocks, "backward": blocks}, 0) if on_card \
        else ({"forward": 0, "backward": 0}, 0)
    log(f"[legacy] loss backward, batch {loss_batch} x {max(tf)} frames: "
        f"loss {runs[device][0]:.5f} vs CPU {runs['cpu'][0]:.5f} (rel "
        f"{loss_err:.2e}, tol {TRAIN_METRIC_RTOL:g}); worst leaf gradient "
        f"{grad_err[worst]:.2e} of its largest ({worst}; tol "
        f"{TRAIN_GRAD_RTOL:g}; {len(symmetric)} key biases zero by symmetry "
        f"held to the model's largest); {runs[device][3]:.3f} s on {device}; "
        f"(K2, K1) {runs[device][2]} (expected {want})")
    if loss_err > TRAIN_METRIC_RTOL or grad_err[worst] > TRAIN_GRAD_RTOL \
            or runs[device][2] != want:
        raise AssertionError("the legacy flow loss differs card vs CPU")
    rec = {"launches": {"legacy_flow_inference": k1,
                        "legacy_flow_loss": sum(runs[device][2][0].values())}}
    del models, model

    # the legacy LM: loss, accuracy and backward, card vs CPU
    lcfg = llm.LegacyLMConfig()
    rng = np.random.default_rng(46)
    texts = [rng.integers(0, lcfg.text_vocab_size, int(n))
             for n in rng.integers(30, 60, lm_batch_n)]
    speech = [rng.integers(0, lcfg.speech_token_size, int(n))
              for n in rng.integers(150, 250, lm_batch_n)]
    plan = llm_mod.build_lm_plan(texts, speech, eos=lcfg.speech_token_size,
                                 fill=lcfg.speech_token_size + 2)
    text_token = np.zeros((lm_batch_n, max(len(t) for t in texts)), np.int64)
    for i, t in enumerate(texts):
        text_token[i, :len(t)] = t
    args = [torch.as_tensor(np.asarray(plan[k])) for k in
            ("src_type", "tok_id", "target", "seq_len")] + [
        torch.as_tensor(rng.standard_normal((lm_batch_n,
                                             lcfg.llm_input_size)),
                        dtype=torch.float32),
        torch.as_tensor(text_token),
        torch.tensor([len(t) for t in texts])]
    out = {}
    for dev in ("cpu", device):
        lm = params_io.init_params(llm.LegacyTransformerLM(lcfg),
                                   torch.Generator().manual_seed(0)).to(dev)
        t0 = time.perf_counter()
        loss, acc = lm(*(a.to(dev) for a in args))
        grads = torch.autograd.grad(loss, list(lm.parameters()))
        gn = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
        out[dev] = (float(loss), float(acc), gn, time.perf_counter() - t0)
        del lm
    rel = max(abs(out[device][i] - out["cpu"][i]) / abs(out["cpu"][i])
              for i in (0, 2))
    # the accuracy counts argmax hits: one flip of a near-tie moves it
    # by one target
    n_targets = int((np.asarray(plan["target"]) >= 0).sum())
    acc_flips = abs(out[device][1] - out["cpu"][1]) * n_targets
    log(f"[legacy] LegacyTransformerLM at LegacyLMConfig(), {lm_batch_n} "
        f"plans of length {int(np.asarray(plan['seq_len']).max())}: loss "
        f"{out[device][0]:.5f}, acc {out[device][1]:.4f}, grad norm "
        f"{out[device][2]:.4f} vs CPU {out['cpu'][0]:.5f}, "
        f"{out['cpu'][1]:.4f}, {out['cpu'][2]:.4f} (loss and grad norm "
        f"worst rel {rel:.2e}, tol {TRAIN_METRIC_RTOL:g}; accuracy "
        f"{acc_flips:.0f} of {n_targets} targets apart, tol 1); forward "
        f"and backward {out[device][3]:.3f} s on {device}")
    if rel > TRAIN_METRIC_RTOL or acc_flips > 1.5:
        raise AssertionError("the legacy LM differs card vs CPU")
    if not on_card:
        return rec
    u = cfg.unet
    gen = torch.Generator(device="cuda").manual_seed(44)
    rec["k1"] = {}
    for t in (total, (total + 1) // 2):
        shape = (2, u.num_heads, t, u.attention_head_dim)
        k1_agreement([(shape, [t, t])], {"full": {}}, gen)
        rec["k1"][f"legacy_T{t}"] = k1_timing(gen, shape, [t, t])
    shape = (loss_batch, u.num_heads, max(tf), u.attention_head_dim)
    k2_agreement([(shape, tf)], {"full": K2_MODES["full"]}, gen)
    rec["k2"] = k2_timing(gen, shape, tf, "full")
    return rec



# --- flowae (phases 45-48) ---------------------------------------------------
FLOWAE_SECONDS, FLOWAE_CLIPS = 5.0, 2  # the decode: 2 clips of 5 s
FLOWAE_PATHS = ("dito_decode", "dito_train", "zdm_train", "zdm_generate",
                "glpto_train", "dito_image_train", "dito_image_decode",
                "image_zdm_train", "image_zdm_generate", "vqgan_train",
                "flowae_clis")
FLOWAE_CROP, FLOWAE_BATCH = 16384, 4   # the train steps
FLOWAE_CPU_LEN = 4096                  # card vs CPU, samples
FLOWAE_RTOL = 1e-4   # forward outputs and Euler decodes, of the peak
# the adaptive GAN weights (a ratio of two gradient norms) and the totals
# they scale, card vs CPU: GLPTo's perceptual (STFT log-magnitude) term
# has the input gradient 2 / (|S| ln 10) per bin, which magnifies float32
# rounding of the smallest magnitudes to a few 1e-4
# (tests/test_torch_flowae.py); LPIPS's VGG ReLUs flip gates under
# rounding (as phase 43's text encoder), moving the VQGAN's by ~4e-4
ADAPTIVE_WEIGHT_RTOL = 1e-3


def flowae_len(seconds: float, sr: int = 24000) -> int:
    """The longest multiple of 1024 (the DiT's 64 x 16) in `seconds`."""
    return int(seconds * sr) // 1024 * 1024


def no_attention_kernels(what: str):
    k2, k1 = read_counts()
    if k1 or sum(k2.values()):
        raise AssertionError(f"{what}: K1 {k1}, K2 {k2} launched")


def _peak_reset(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device) -> float:
    import torch
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 2**30


def _timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def _init(module, seed: int, device):
    import torch

    from minimax_speech_torch.utils import params_io
    return params_io.init_params(
        module, torch.Generator().manual_seed(seed)).to(device)


def _clips(n: int, length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([speechlike(rng, length) for _ in range(n)])[..., None]


def _step_times(step_once, device, warm: int = 1, timed: int = 3) -> tuple:
    """(median seconds of `timed` calls after `warm`, the last metrics)."""
    for _ in range(warm):
        step_once()
    secs = []
    for _ in range(timed):
        m, dt = _timed(step_once, device)
        secs.append(dt)
    m = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"non-finite metrics {m}")
    return statistics.median(secs), m


def _state(module):
    from minimax_speech_torch.train import schedule, steps
    return steps.make_train_state(module, schedule.make_optimizer(
        lr=1e-4, warmup_steps=0))


def _held_grads(label, grads: dict, ref: dict, rtol=TRAIN_GRAD_RTOL):
    """Every leaf within rtol of its largest element; a key bias (0 but
    for rounding under softmax) of the model's largest."""
    sym = [n for n in ref if n.endswith("k.bias")]
    err = grad_errors(grads, ref, sym)
    worst = max(err, key=err.get)
    log(f"[flowae] {label}: {len(err)} leaves, worst gradient "
        f"{err[worst]:.2e} of its largest ({worst}; tol {rtol:g})")
    if err[worst] > rtol:
        raise AssertionError(f"{label}: gradients differ card vs CPU")


def _rel(label, a: float, b: float, rtol: float):
    d = abs(a - b) / max(abs(b), 1e-12)
    if d > rtol:
        raise AssertionError(f"{label}: {a} vs {b} (rel {d:.2e} > {rtol})")
    return d


def _peak_err(label, a, b, rtol=FLOWAE_RTOL) -> float:
    a, b = a.detach().cpu().float(), b.detach().cpu().float()
    err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    if a.shape != b.shape or not torch_finite(a) or err > rtol:
        raise AssertionError(f"{label}: {err:.2e} of the peak (tol {rtol})")
    return err


def torch_finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def _grads_of(module, loss) -> dict:
    """{name: the gradient of loss, on the CPU} of every parameter."""
    import torch
    gs = torch.autograd.grad(loss, list(module.parameters()),
                             allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
            for (n, p), g in zip(module.named_parameters(), gs)}


def dito_cross_check(cfg, device, length: int = FLOWAE_CPU_LEN,
                     n_steps: int = 3) -> dict:
    """The DiTo at cfg, card vs CPU on the same weights and draws at
    `length` samples: the loss (zaug 0.5) and every leaf's gradient, and
    an n_steps decode with CFG 2.0 from the same noise."""
    import torch

    from minimax_speech_torch.flowae import dito
    x = torch.as_tensor(_clips(2, length, 451))
    draws = dito.make_dito_draws(cfg, x.shape,
                                 torch.Generator().manual_seed(452), 0.5)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    runs = {}
    for dev in ("cpu", device):
        model = _init(dito.DiToAudio(cfg, length), 0, dev)
        rec, kl, _ = model.loss(x.to(dev), draws.to(dev), 0.5)
        grads = _grads_of(model, rec + 1e-4 * kl)
        with torch.no_grad():
            mu = model.encode(x.to(dev))[1]
        out = dito.dito_decode(model, mu, length, noise, n_steps=n_steps,
                               guidance=2.0)
        runs[dev] = (float(rec.detach()), float(kl.detach()), grads, out)
    (rc, kc, gc, oc), (rd, kd, gd, od) = runs["cpu"], runs[device]
    d = max(_rel("DiTo rec loss", rd, rc, TRAIN_METRIC_RTOL),
            _rel("DiTo kl", kd, kc, TRAIN_METRIC_RTOL))
    e = _peak_err("DiTo decode", od, oc)
    log(f"[flowae] DiTo {cfg.renderer_type} card vs CPU at {length} "
        f"samples: loss {rd:.6f} vs {rc:.6f} (rel {d:.2e}, tol "
        f"{TRAIN_METRIC_RTOL:g}); {n_steps}-step CFG decode {e:.2e} of its "
        f"peak (tol {FLOWAE_RTOL:g})")
    _held_grads(f"DiTo {cfg.renderer_type} gradients", gd, gc)
    return {"loss_rel": d, "decode_err": e}


def dito_phase(card: str, device="cuda", seconds=FLOWAE_SECONDS,
               crop=FLOWAE_CROP, batch=FLOWAE_BATCH, n_steps=18,
               cpu_len=FLOWAE_CPU_LEN, renderers=("dit", "unet")) -> dict:
    """Phase 45: DiToConfig() with each renderer: encode and an n_steps
    decode of FLOWAE_CLIPS clips of `seconds`, without and with CFG 2.0;
    make_dito_step at `batch` x `crop`, bf16 off and on; card vs CPU
    (dito_cross_check). K1 and K2 0. Returns the record and the DiT
    DiTo (phase 46's autoencoder and phase 48's --ckpt)."""
    import torch

    from minimax_speech_torch.flowae import dito, trainer
    n = flowae_len(seconds)
    x = torch.as_tensor(_clips(FLOWAE_CLIPS, n, 45), device=device)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    train_x = torch.as_tensor(_clips(batch, crop, 46), device=device)
    rec, keep = {}, None
    for r in renderers:
        cfg = dataclasses.replace(dito.DiToConfig(), renderer_type=r)
        _peak_reset(device)
        reset_counts()
        model = _init(dito.DiToAudio(cfg, n), 0, device)
        with torch.no_grad():
            model.encode(x)  # warm-up: cuDNN's and cuBLAS's first calls
            (_, mu, _), enc_s = _timed(lambda: model.encode(x), device)
        dito.dito_decode(model, mu, n, noise, n_steps=1)
        out = {"encode_s": enc_s}
        for g in (1.0, 2.0):
            y, dt = _timed(lambda: dito.dito_decode(
                model, mu, n, noise, n_steps=n_steps, guidance=g), device)
            if y.shape != x.shape or not torch_finite(y):
                raise AssertionError("DiTo decode: bad output")
            out[f"cfg{g:g}"] = {"decode_s": dt, "ms_per_step":
                                1e3 * dt / n_steps,
                                "rtf": dt / (FLOWAE_CLIPS * seconds)}
        out["decode_peak_gib"] = _peak_gib(device)
        if torch.device(device).type == "cuda":
            out["profile"] = profile_step(lambda: dito.dito_decode(
                model, mu, n, noise, n_steps=1), f"one DiTo {r} render step "
                f"at {FLOWAE_CLIPS} x {n}")
        model = model.cpu() if r == "dit" else None
        for bf16 in (False, True):
            _peak_reset(device)
            tm = _init(dito.DiToAudio(cfg, crop), 0, device)
            state, ema = _state(tm), trainer.ema_init(tm)
            step = trainer.make_dito_step(tm, bf16=bf16, device=device)
            gen = torch.Generator().manual_seed(47)

            def once():
                return step(state, ema, {"audio": train_x},
                            dito.make_dito_draws(cfg, train_x.shape, gen,
                                                 0.1).to(device))[2]
            step_s, m = _step_times(once, device)
            out[f"train_bf16_{bf16}"] = {"step_s": step_s, "peak_gib":
                                         _peak_gib(device),
                                         "loss": m["loss"]}
            del tm, state, ema
        no_attention_kernels(f"DiTo ({r})")
        c = out["cfg1"], out["cfg2"]
        tokens = f", {n // 16} DiT tokens" if r == "dit" else ""
        log(f"[flowae] {card} | DiTo {r} renderer, {FLOWAE_CLIPS} x "
            f"{seconds:g} s ({n} samples{tokens}): "
            f"encode {1e3 * enc_s:.1f} ms; {n_steps}-step decode "
            f"{c[0]['decode_s']:.3f} s ({c[0]['ms_per_step']:.2f} ms/step, "
            f"RTF {c[0]['rtf']:.4f}), with CFG 2.0 {c[1]['decode_s']:.3f} s "
            f"({c[1]['ms_per_step']:.2f} ms/step, RTF {c[1]['rtf']:.4f}); "
            f"peak {out['decode_peak_gib']:.2f} GiB | make_dito_step B "
            f"{batch} x {crop}: step_s {out['train_bf16_False']['step_s']:.4f}"
            f" (peak {out['train_bf16_False']['peak_gib']:.2f} GiB), bf16 "
            f"{out['train_bf16_True']['step_s']:.4f} (peak "
            f"{out['train_bf16_True']['peak_gib']:.2f} GiB) | K1 0, K2 0")
        out["cross"] = dito_cross_check(cfg, device, cpu_len)
        rec[r] = out
        if r == "dit":
            keep = model.to(device)
    return rec, keep


def zdm_glpto_phase(card: str, ae, device="cuda", seconds=FLOWAE_SECONDS,
                    crop=FLOWAE_CROP, batch=FLOWAE_BATCH,
                    cpu_len=FLOWAE_CPU_LEN) -> dict:
    """Phase 46: ZDMConfig() over `ae` (the DiT DiTo): make_zdm_step at
    `batch` x `crop`, zdm_generate of FLOWAE_CLIPS x `seconds` with its
    decode; GLPToConfig() and the MSD: a generator and a discriminator
    step at `batch` x `crop`; card vs CPU at cpu_len samples. K1, K2 0."""
    import torch

    from minimax_speech_torch.flowae import fm, glpto, trainer, zdm
    from minimax_speech_torch.models.discriminators import MSD
    n = flowae_len(seconds)
    zcfg = zdm.ZDMConfig()
    train_x = torch.as_tensor(_clips(batch, crop, 46), device=device)
    rec = {}
    reset_counts()
    _peak_reset(device)
    prior = _init(zdm.ZDMNet(zcfg, n // 64), 1, device)
    state, ema = _state(prior), trainer.ema_init(prior)
    step = zdm.make_zdm_step(prior, ae, device=device)
    gen = torch.Generator().manual_seed(48)
    rec["zdm_train_step_s"], m = _step_times(lambda: step(
        state, ema, {"audio": train_x}, fm.make_fm_draws(
            zcfg.fm, (batch, crop // 64, zcfg.z_dim), gen).to(device))[2],
        device)
    rec["zdm_train_peak_gib"] = _peak_gib(device)
    _peak_reset(device)
    noise = zdm.start_noises(None, torch.Generator().manual_seed(2), [
        (FLOWAE_CLIPS, n // 64, zcfg.z_dim), (FLOWAE_CLIPS, n, 1)], "cpu")
    y, rec["zdm_generate_s"] = _timed(lambda: zdm.zdm_generate(
        prior, ae, FLOWAE_CLIPS, n // 64, n, noise), device)
    if y.shape != (FLOWAE_CLIPS, n, 1) or not torch_finite(y):
        raise AssertionError("zdm_generate: bad output")
    rec["zdm_generate_peak_gib"] = _peak_gib(device)
    del prior, state, ema

    _peak_reset(device)
    gcfg = glpto.GLPToConfig()
    g = _init(glpto.GLPToAudio(gcfg), 2, device)
    d = _init(MSD(), 3, device)
    gen_step, disc_step = glpto.make_glpto_steps(g, d, gcfg, device=device)
    g_state, d_state = _state(g), _state(d)
    egen = torch.Generator().manual_seed(49)

    def eps():
        return torch.randn((batch, crop // 64, gcfg.z_dim),
                           generator=egen).to(device)
    rec["glpto_disc_step_s"], _ = _step_times(
        lambda: disc_step(d_state, {"audio": train_x}, eps())[1], device)
    rec["glpto_gen_step_s"], m = _step_times(
        lambda: gen_step(g_state, {"audio": train_x}, eps())[1], device)
    rec["glpto_peak_gib"] = _peak_gib(device)
    del g, d, g_state, d_state
    no_attention_kernels("ZDM and GLPTo")
    log(f"[flowae] {card} | ZDM (DiT 128 x 4, {n // 64} latent frames "
        f"built): make_zdm_step B {batch} x {crop // 64} frames step_s "
        f"{rec['zdm_train_step_s']:.4f} (peak "
        f"{rec['zdm_train_peak_gib']:.2f} GiB); zdm_generate "
        f"{FLOWAE_CLIPS} x {seconds:g} s (18 prior + 18 render steps) "
        f"{rec['zdm_generate_s']:.3f} s, RTF "
        f"{rec['zdm_generate_s'] / (FLOWAE_CLIPS * seconds):.4f} (peak "
        f"{rec['zdm_generate_peak_gib']:.2f} GiB) | GLPTo + MSD B {batch} x "
        f"{crop}: gen step_s {rec['glpto_gen_step_s']:.4f}, disc step_s "
        f"{rec['glpto_disc_step_s']:.4f} (peak {rec['glpto_peak_gib']:.2f} "
        f"GiB; adaptive weight {m['gen/adaptive_w']:.4g}) | K1 0, K2 0")
    rec["cross"] = zdm_glpto_cross_check(ae.cfg, device, cpu_len)
    return rec


def zdm_glpto_cross_check(ae_cfg, device, length=FLOWAE_CPU_LEN) -> dict:
    """Card vs CPU at `length` samples, the same weights and draws: the
    prior's step loss and every leaf's gradient over the DiTo's latents;
    GLPTo's generator losses (the adaptive weight and total within
    ADAPTIVE_WEIGHT_RTOL with the perceptual term), every generator leaf's
    gradient without it, the discriminator's loss and gradients."""
    import torch

    from minimax_speech_torch.flowae import dito, fm, glpto, zdm
    from minimax_speech_torch.models.discriminators import MSD
    x = torch.as_tensor(_clips(2, length, 461))
    zcfg = zdm.ZDMConfig()
    draws = fm.make_fm_draws(zcfg.fm, (2, length // 64, zcfg.z_dim),
                             torch.Generator().manual_seed(462))
    eps = torch.randn((2, length // 64, 32),
                      generator=torch.Generator().manual_seed(463))
    runs = {}
    for dev in ("cpu", device):
        ae = _init(dito.DiToAudio(ae_cfg, length), 0, dev)
        prior = _init(zdm.ZDMNet(zcfg, length // 64), 1, dev)
        with torch.no_grad():
            z = zdm.normalize_latents(ae.encode(x.to(dev))[1])
        loss = fm.fm_loss(lambda a, t: prior(a, t), z, zcfg.fm, draws.to(dev))
        out = {"zdm": (float(loss.detach()), _grads_of(prior, loss))}
        for pw in (1.0, 0.0):
            gcfg = glpto.GLPToConfig(perceptual_weight=pw)
            g = _init(glpto.GLPToAudio(gcfg), 2, dev)
            d = _init(MSD(), 3, dev)
            gen_step, disc_step = glpto.make_glpto_steps(g, d, gcfg,
                                                         device=dev)
            seen = []
            orig = glpto.backward_and_update
            glpto.backward_and_update = lambda st, loss: seen.append(
                orig(st, loss)) or seen[-1]
            try:
                _, gm = gen_step(_state(g), {"audio": x.to(dev)}, eps.to(dev))
                if pw:
                    g = _init(glpto.GLPToAudio(gcfg), 2, dev)
                    _, dm = glpto.make_glpto_steps(g, d, gcfg, device=dev)[
                        1](_state(d), {"audio": x.to(dev)}, eps.to(dev))
            finally:
                glpto.backward_and_update = orig
            names = [nm for nm, _ in g.named_parameters()]
            out[f"gen{pw:g}"] = ({k: float(v) for k, v in gm.items()},
                                 dict(zip(names, (t.cpu() for t in seen[0]))))
            if pw:
                dn = [nm for nm, _ in d.named_parameters()]
                out["disc"] = (float(dm["disc/loss"]),
                               dict(zip(dn, (t.cpu() for t in seen[1]))))
        runs[dev] = out
    c, k = runs["cpu"], runs[device]
    _rel("ZDM loss", k["zdm"][0], c["zdm"][0], TRAIN_METRIC_RTOL)
    _held_grads("ZDM gradients", k["zdm"][1], c["zdm"][1])
    for key in ("gen/nll", "gen/kl", "gen/g_adv"):
        _rel(f"GLPTo {key}", k["gen1"][0][key], c["gen1"][0][key],
             TRAIN_METRIC_RTOL)
    w = _rel("GLPTo adaptive weight", k["gen1"][0]["gen/adaptive_w"],
             c["gen1"][0]["gen/adaptive_w"], ADAPTIVE_WEIGHT_RTOL)
    _rel("GLPTo total", k["gen1"][0]["gen/loss"], c["gen1"][0]["gen/loss"],
         ADAPTIVE_WEIGHT_RTOL)
    w0 = _rel("GLPTo adaptive weight (no perceptual term)",
              k["gen0"][0]["gen/adaptive_w"], c["gen0"][0]["gen/adaptive_w"],
              TRAIN_METRIC_RTOL)
    _held_grads("GLPTo generator gradients (no perceptual term)",
                k["gen0"][1], c["gen0"][1])
    _rel("GLPTo disc loss", k["disc"][0], c["disc"][0], TRAIN_METRIC_RTOL)
    _held_grads("GLPTo discriminator gradients", k["disc"][1], c["disc"][1])
    log(f"[flowae] ZDM and GLPTo card vs CPU at {length} samples: ZDM loss "
        f"{k['zdm'][0]:.6f} vs {c['zdm'][0]:.6f}; GLPTo adaptive weight "
        f"{k['gen1'][0]['gen/adaptive_w']:.6g} vs "
        f"{c['gen1'][0]['gen/adaptive_w']:.6g} (rel {w:.2e}, tol "
        f"{ADAPTIVE_WEIGHT_RTOL:g}), without the perceptual term rel "
        f"{w0:.2e} (tol {TRAIN_METRIC_RTOL:g})")
    return {"glpto_weight_rel": w, "glpto_weight_rel_no_perceptual": w0}


def image_phase(card: str, device="cuda", size=256, batch=4,
                render_steps=None, cpu_size=32) -> dict:
    """Phase 47: DiToImageConfig() a train step and a decode at
    render_steps (default 50) of `batch` images of size^2;
    ImageZDMConfig(n_classes=10) a step and generation with CFG 2.0;
    VQGANConfig() the generator step (LPIPS, adaptive weight) and the
    discriminator step; card vs CPU at cpu_size. K1, K2 0."""
    import torch

    from minimax_speech_torch.data.image_folder import synthetic_images
    from minimax_speech_torch.flowae import dito, image, trainer, vqgan
    rec = {}
    hw = (size, size)
    x = torch.as_tensor(synthetic_images(batch, size, 47), device=device)
    reset_counts()
    _peak_reset(device)
    cfg = image.DiToImageConfig()
    ae = _init(image.DiToImage(cfg, hw), 0, device)
    state, ema = _state(ae), trainer.ema_init(ae)
    step = image.make_dito_image_step(ae, device=device)
    gen = torch.Generator().manual_seed(50)
    rec["dito_train_step_s"], _ = _step_times(lambda: step(
        state, ema, {"image": x}, dito.make_dito_draws(
            cfg, x.shape, gen, 0.1).to(device))[2], device, timed=2)
    rec["dito_train_peak_gib"] = _peak_gib(device)
    del state, ema
    _peak_reset(device)
    steps_n = render_steps or cfg.render_n_steps
    with torch.no_grad():
        mu = ae.encode(x)[1]
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    image.dito_image_decode(ae, mu, hw, noise, n_steps=1)  # warm-up
    y, dt = _timed(lambda: image.dito_image_decode(ae, mu, hw, noise,
                                                   n_steps=steps_n), device)
    if y.shape != x.shape or not torch_finite(y):
        raise AssertionError("dito_image_decode: bad output")
    rec["decode_s"], rec["decode_ms_per_step"] = dt, 1e3 * dt / steps_n
    rec["decode_peak_gib"] = _peak_gib(device)
    if torch.device(device).type == "cuda":
        rec["profile"] = profile_step(lambda: image.dito_image_decode(
            ae, mu, hw, noise, n_steps=1), f"one image DiTo render step at "
            f"{batch} x {size}^2")

    _peak_reset(device)
    z_hw = tuple(mu.shape[1:3])
    zcfg = image.ImageZDMConfig(n_classes=10, guidance=2.0,
                                net=dataclasses.replace(
                                    image.ImageZDMConfig().net, cond_dim=64))
    prior = _init(image.ImageZDMNet(zcfg, z_hw), 1, device)
    pstate, pema = _state(prior), trainer.ema_init(prior)
    pstep = image.make_image_zdm_step(prior, ae, device=device)
    labels = torch.arange(batch, device=device) % 10
    rec["zdm_train_step_s"], _ = _step_times(lambda: pstep(
        pstate, pema, {"image": x, "label": labels},
        image.make_image_zdm_draws(zcfg, (batch,) + z_hw + (4,),
                                   gen).to(device))[2], device)
    noises = [torch.randn((batch,) + z_hw + (4,),
                          generator=torch.Generator().manual_seed(6)),
              noise]
    y, rec["zdm_generate_s"] = _timed(lambda: image.image_zdm_generate(
        prior, ae, batch, z_hw, hw, noises, render_steps=steps_n,
        class_labels=np.arange(batch) % 10), device)
    if y.shape != x.shape or not torch_finite(y):
        raise AssertionError("image_zdm_generate: bad output")
    rec["zdm_peak_gib"] = _peak_gib(device)
    del ae, prior, pstate, pema

    _peak_reset(device)
    vq = _init(vqgan.VQGAN(vqgan.VQGANConfig()), 2, device)
    disc = _init(vqgan.NLayerDiscriminator(), 3, device)
    lpips = _init(vqgan.LPIPS(), 4, device)
    gen_step, disc_step = vqgan.make_vqgan_steps(vq, disc, lpips,
                                                 device=device)
    gs, ds = _state(vq), _state(disc)
    rec["vqgan_disc_step_s"], _ = _step_times(
        lambda: disc_step(ds, {"image": x})[1], device)
    rec["vqgan_gen_step_s"], m = _step_times(
        lambda: gen_step(gs, {"image": x})[1], device)
    rec["vqgan_peak_gib"] = _peak_gib(device)
    del vq, disc, lpips, gs, ds
    no_attention_kernels("the image track")
    log(f"[flowae] {card} | image DiTo f8c4 (UNet 128/256/512) B {batch} x "
        f"{size}^2: train step_s {rec['dito_train_step_s']:.4f} (peak "
        f"{rec['dito_train_peak_gib']:.2f} GiB); {steps_n}-step decode "
        f"{rec['decode_s']:.3f} s ({rec['decode_ms_per_step']:.2f} ms/step, "
        f"peak {rec['decode_peak_gib']:.2f} GiB) | ImageZDM (10 classes) "
        f"step_s {rec['zdm_train_step_s']:.4f}, CFG generation "
        f"{rec['zdm_generate_s']:.3f} s (peak {rec['zdm_peak_gib']:.2f} "
        f"GiB) | VQGAN + LPIPS gen step_s {rec['vqgan_gen_step_s']:.4f} "
        f"(adaptive weight {m['vq/adaptive_w']:.4g}), disc step_s "
        f"{rec['vqgan_disc_step_s']:.4f} (peak {rec['vqgan_peak_gib']:.2f} "
        f"GiB) | K1 0, K2 0")
    rec["cross"] = image_cross_check(device, cpu_size)
    return rec


def image_cross_check(device, size=32) -> dict:
    """Card vs CPU at size^2, B 2, the same weights and draws: the image
    DiTo's loss and every leaf's gradient and a 3-step decode; the
    class-conditional prior's loss and gradients; the VQGAN generator
    step's losses and weight (VQ indices equal) and the discriminator's
    gradients."""
    import torch

    from minimax_speech_torch.data.image_folder import synthetic_images
    from minimax_speech_torch.flowae import dito, fm, image, vqgan
    hw = (size, size)
    x = torch.as_tensor(synthetic_images(2, size, 471))
    cfg = image.DiToImageConfig()
    draws = dito.make_dito_draws(cfg, x.shape,
                                 torch.Generator().manual_seed(472), 0.5)
    zcfg = image.ImageZDMConfig(n_classes=10, net=dataclasses.replace(
        image.ImageZDMConfig().net, cond_dim=64))
    z_hw = (size // 8,) * 2
    zdraws = image.ImageZDMDraws(
        fm.make_fm_draws(zcfg.fm, (2,) + z_hw + (4,),
                         torch.Generator().manual_seed(473)),
        torch.tensor([True, False]))
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    labels = torch.tensor([3, 7])
    runs = {}
    for dev in ("cpu", device):
        ae = _init(image.DiToImage(cfg, hw), 0, dev)
        rec_l, kl, _ = ae.loss(x.to(dev), draws.to(dev), 0.5)
        out = {"ae": (float(rec_l.detach()),
                      _grads_of(ae, rec_l + 1e-4 * kl))}
        with torch.no_grad():
            mu = ae.encode(x.to(dev))[1]
            z = image.normalize_latents(mu)
        out["decode"] = image.dito_image_decode(ae, mu, hw, noise, n_steps=3)
        prior = _init(image.ImageZDMNet(zcfg, z_hw), 1, dev)
        lab = torch.where(zdraws.drop.to(dev), 10, labels.to(dev))
        zl = fm.fm_loss(lambda a, t: prior(a, t, class_labels=lab), z,
                        zcfg.fm, zdraws.fm.to(dev))
        out["zdm"] = (float(zl.detach()), _grads_of(prior, zl))
        vq = _init(vqgan.VQGAN(vqgan.VQGANConfig()), 2, dev)
        disc = _init(vqgan.NLayerDiscriminator(), 3, dev)
        lp = _init(vqgan.LPIPS(), 4, dev)
        with torch.no_grad():
            idx = vq(x.to(dev))[2].cpu()
        gen_step, disc_step = vqgan.make_vqgan_steps(vq, disc, lp,
                                                     device=dev)
        seen = []
        orig = vqgan.backward_and_update
        vqgan.backward_and_update = lambda st, loss: seen.append(
            orig(st, loss)) or seen[-1]
        try:
            _, dm = disc_step(_state(disc), {"image": x.to(dev)})
            disc = _init(vqgan.NLayerDiscriminator(), 3, dev)
            _, gm = vqgan.make_vqgan_steps(vq, disc, lp, device=dev)[0](
                _state(vq), {"image": x.to(dev)})
        finally:
            vqgan.backward_and_update = orig
        dn = [nm for nm, _ in disc.named_parameters()]
        out["vq"] = (idx, {k: float(v) for k, v in gm.items()},
                     float(dm["disc/loss"]),
                     dict(zip(dn, (t.cpu() for t in seen[0]))))
        runs[dev] = out
    c, k = runs["cpu"], runs[device]
    _rel("image DiTo loss", k["ae"][0], c["ae"][0], TRAIN_METRIC_RTOL)
    _held_grads("image DiTo gradients", k["ae"][1], c["ae"][1])
    e = _peak_err("image DiTo decode", k["decode"], c["decode"])
    _rel("image ZDM loss", k["zdm"][0], c["zdm"][0], TRAIN_METRIC_RTOL)
    _held_grads("image ZDM gradients", k["zdm"][1], c["zdm"][1])
    if not torch.equal(k["vq"][0], c["vq"][0]):
        raise AssertionError("VQGAN: the codebook indices differ")
    for key, v in c["vq"][1].items():
        _rel(f"VQGAN {key}", k["vq"][1][key], v, ADAPTIVE_WEIGHT_RTOL
             if key in ("vq/adaptive_w", "vq/loss") else TRAIN_METRIC_RTOL)
    _rel("VQGAN disc loss", k["vq"][2], c["vq"][2], TRAIN_METRIC_RTOL)
    _held_grads("VQGAN discriminator gradients", k["vq"][3], c["vq"][3])
    log(f"[flowae] image track card vs CPU at {size}^2: DiTo loss "
        f"{k['ae'][0]:.6f} vs {c['ae'][0]:.6f}, 3-step decode {e:.2e} of its "
        f"peak; VQ indices equal, adaptive weight "
        f"{k['vq'][1]['vq/adaptive_w']:.6g} vs "
        f"{c['vq'][1]['vq/adaptive_w']:.6g}")
    return {"decode_err": e}


def flowae_cli_phase(card: str, ae, device=None) -> dict:
    """Phase 48: the four flowae CLIs in this process, each at its
    default --device (cuda; `device` names another for a rehearsal):
    train_flowae --synthetic --model dito, then --model zdm --ae_params;
    dito_infer --ckpt (`ae`, a DiToConfig() DiTo, saved) on a written
    wav; train_flowae_image --synthetic dito, then zdm --class_cond;
    image_dito --sample. Checks the files each writes; K1, K2 0."""
    import importlib.util
    import shutil
    import tempfile

    from minimax_speech_torch.cli import (dito_infer, image_dito,
                                          train_flowae, train_flowae_image)
    from minimax_speech_torch.cli.synthesize import write_wav
    from minimax_speech_torch.utils import params_io
    if importlib.util.find_spec("PIL") is None:
        log("[flowae] PIL is not installed here: the CLIs run on synthetic "
            "images and write their PNGs without it; the folder and tar "
            "readers are held on the CPU by tests/test_torch_flowae_image.py")
    dev = [] if device is None else ["--device", device]
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="flowae_", dir=repo / "build"))
    times = {}
    try:
        reset_counts()

        def run(name, main, argv, want):
            t0 = time.perf_counter()
            main(argv + dev)
            times[name] = time.perf_counter() - t0
            missing = [w for w in want if not (root / w).is_file()
                       or (root / w).stat().st_size == 0]
            if missing:
                raise AssertionError(f"{name} wrote no {missing}")

        audio = ["--synthetic", "--steps", "3", "--eval_every", "0",
                 "--save_every", "2", "--max_clips", "8", "--eval_batches",
                 "1", "--eval_n_steps", "4", "--n_vis", "1"]
        run("train_flowae_dito", train_flowae.main,
            ["--model", "dito", "--save_dir", str(root / "ae")] + audio,
            ["ae/ae_params.npz", "ae/dito_metrics.jsonl", "ae/config.json",
             "ae/cache/audio_gen/0.wav", "ae/ckpt/2/state.pt",
             "ae/ckpt/3/state.pt"])
        run("train_flowae_zdm", train_flowae.main,
            ["--model", "zdm", "--save_dir", str(root / "zdm"),
             "--ae_params", str(root / "ae" / "ae_params.npz")] + audio,
            ["zdm/zdm_metrics.jsonl", "zdm/cache/audio_gen/0.wav",
             "zdm/audio_samples/audio_zdm_generated_0_step_3.wav"])
        params_io.save_params(str(root / "dito.npz"), ae)
        # 2 s, or what the autoencoder's DiT was built for if shorter
        n = min(2 * 24000, ae.renderer.n_tok * ae.cfg.renderer.patch)
        write_wav(str(root / "in.wav"), speechlike(
            np.random.default_rng(48), n), 24000)
        run("dito_infer", dito_infer.main,
            ["--wav", str(root / "in.wav"), "--ckpt", str(root / "dito.npz"),
             "--out", str(root / "rec.wav"), "--latents_out",
             str(root / "z.npy")], ["rec.wav", "z.npy"])
        z = np.load(root / "z.npy")
        if z.shape != (n // 1024 * 16, 32) or \
                not np.isfinite(z).all():
            raise AssertionError(f"dito_infer latents {z.shape}")
        image = ["--synthetic", "--steps", "2", "--eval_every", "0",
                 "--save_every", "0", "--max_images", "8", "--eval_n_steps",
                 "4"]
        run("train_flowae_image_dito", train_flowae_image.main,
            ["--model", "dito", "--save_dir", str(root / "iae")] + image,
            ["iae/ae_params.npz", "iae/recon_2.png", "iae/dito_metrics.jsonl"])
        run("train_flowae_image_zdm", train_flowae_image.main,
            ["--model", "zdm", "--class_cond", "--save_dir",
             str(root / "izdm"), "--ae_params",
             str(root / "iae" / "ae_params.npz")] + image,
            ["izdm/zdm_params.npz", "izdm/samples_2.png"])
        run("image_dito_sample", image_dito.main,
            ["--ae_params", str(root / "iae" / "ae_params.npz"),
             "--zdm_params", str(root / "izdm" / "zdm_params.npz"),
             "--n_classes", "2", "--sample", "4", "--n_steps", "4",
             "--output", str(root / "samples.png")], ["samples.png"])
        png = (root / "samples.png").read_bytes()
        if png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError("image_dito wrote no PNG")
        no_attention_kernels("the flowae CLIs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[flowae] {card} | the CLIs at their default --device"
        f"{'' if device is None else ' (' + device + ')'}: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in times.items()) + " | K1 0, K2 0")
    return times


EXPORT_BUCKETS = (64, 128, 256)
# --serving's generated length, as phase 17's warm_serving caps it
EXPORT_TOKENS = 20
# the stages export runs, each counted where it is entered first
EXPORT_STAGES = ("s3", "flow", "decode", "llm", "serving", "matcha",
                 "vocoder")


class StageCounts:
    """While open: per call of each wrapped stage entered outside any
    other wrapped stage, K1's and K2's launches, by stage label (the
    seconds are export's own record)."""

    def __init__(self):
        self.calls, self.depth, self.undo = {}, 0, []

    def wrap(self, owner, name: str, label: str):
        real = getattr(owner, name)

        def run(*a, **kw):
            self.depth += 1
            k2_0, k1_0 = read_counts()
            try:
                out = real(*a, **kw)
            finally:
                self.depth -= 1
            if self.depth == 0:
                k2, k1 = read_counts()
                self.calls.setdefault(label, []).append({
                    "k1": k1 - k1_0, "k2": sum(k2.values()) - sum(
                        k2_0.values())})
            return out
        setattr(owner, name, run)
        self.undo.append((owner, name, real))

    def close(self):
        for owner, name, real in reversed(self.undo):
            setattr(owner, name, real)


def export_phase(card: str, device="cuda", config="configs/default.yaml",
                 buckets=EXPORT_BUCKETS, lm_layers: int = PATH_LM_LAYERS,
                 n_tokens: int = EXPORT_TOKENS) -> dict:
    """Phase 49: cli/export.py at the width of `config` (the LM at
    lm_layers layers), from a checkpoint directory of random weights
    (seed 0) written by params_io.save_params, hashed by
    registry.write_manifest, verified, read back by registry.load_model
    and carded by hub_tools; then export.main in this process with
    --ckpt_dir, --buckets, --matcha and --serving (the generated length
    capped at n_tokens as fixed_length does), and a second time without
    --serving: each stage's first-call and second-call seconds per
    bucket. K1 launched 560 times
    per flow bucket and 40 per Matcha bucket (phases 1 and 42's counts),
    never by the other stages, the serving paths' launches counted, K2
    never; K1's library in build/kernels/ afterwards. Returns the
    record."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.cli import export, hub_tools
    from minimax_speech_torch.infer import warmup
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    from minimax_speech_torch.kernels import build
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.models import matcha as matcha_mod
    from minimax_speech_torch.models.matcha_hifigan import MatchaHiFiGAN
    from minimax_speech_torch.models.s3tokenizer import S3TokenizerV2
    from minimax_speech_torch.utils import params_io, registry

    on_card = device == "cuda"
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="export_", dir=repo / "build"))
    overrides = [f"model.lm.qwen.n_layers={lm_layers}",
                 f"model.max_speech_tokens={n_tokens}",
                 f"model.min_token_text_ratio={n_tokens / TEXT_LEN}",
                 f"model.max_token_text_ratio={n_tokens / TEXT_LEN}"]
    cfg = cfg_lib.load_tts_config(repo / config, overrides)
    mcfg = matcha_mod.MatchaConfig()
    want = {"flow": attn_calls_per_step(cfg.flow.unet)
            * cfg.flow.n_timesteps if on_card else 0,
            "matcha": attn_calls_per_step(mcfg.unet) * mcfg.n_timesteps
            if on_card else 0}
    try:
        ckpt = root / "ckpt"
        ckpt.mkdir()
        t0 = time.perf_counter()
        pipe = TTSPipeline.from_random(cfg, seed=0, device=device)
        files = dict(zip(("llm", "flow", "codec", "s3"),
                         pipe.models().values()))
        for name, module in files.items():
            params_io.save_params(str(ckpt / f"{name}.npz"), module)
        manifest = registry.write_manifest(ckpt)
        problems = registry.verify_model_dir(ckpt)
        equal = {}
        for name, module in files.items():
            got = params_io._flatten(registry.load_model(str(ckpt), name))
            ref = params_io._flatten(params_io.to_flax_params(module))
            equal[name] = got.keys() == ref.keys() and all(
                np.array_equal(got[k], a) for k, a in ref.items())
        del pipe, files
        if on_card:
            torch.cuda.empty_cache()
        hub_tools.main(["card", "--model_dir", str(ckpt)])
        card_text = (ckpt / "README.md").read_text()
        mb = sum(p.stat().st_size for p in ckpt.glob("*.npz")) / 2**20
        log(f"[export] {card} | checkpoint dir ({config}, LM at {lm_layers} "
            f"layers, seed 0): {sorted(manifest['files'])} {mb:.1f} MiB in "
            f"{time.perf_counter() - t0:.1f} s | verify_model_dir "
            f"{problems} | load_model equal to the written weights {equal} "
            f"| hub card {len(card_text)} chars")
        if problems or not all(equal.values()) or \
                sorted(manifest["files"]) != ["codec.npz", "flow.npz",
                                              "llm.npz", "s3.npz"] or \
                "minimax_speech_torch" not in card_text:
            raise AssertionError("export's checkpoint directory failed")

        argv = ["--config", str(repo / config), "--ckpt_dir", str(ckpt),
                "--buckets", ",".join(map(str, buckets)), "--device", device,
                *sum((["--override", o] for o in overrides), [])]
        runs = []
        # the second call again without --serving: its subject is each
        # stage's second-call seconds
        for call, warm in (("first", True), ("second", False)):
            flags = ["--matcha", "--serving"] if warm else ["--matcha"]
            counts = StageCounts()
            for owner, name, label in (
                    (S3TokenizerV2, "forward", "s3"),
                    (flow_mod, "flow_inference", "flow"),
                    (TTSPipeline, "decode", "decode"),
                    (llm_mod, "generate", "llm"),
                    (warmup, "warm_serving", "serving"),
                    (matcha_mod, "matcha_synthesise", "matcha"),
                    (MatchaHiFiGAN, "forward", "vocoder")):
                counts.wrap(owner, name, label)
            reset_counts()
            t0 = time.perf_counter()
            try:
                rec = export.main(argv + flags)
            finally:
                counts.close()
            secs = time.perf_counter() - t0
            k2, k1 = read_counts()
            c = counts.calls
            k1_by = {s: [x["k1"] for x in c.get(s, [])]
                     for s in EXPORT_STAGES}
            log(f"[export] {card} | export.main ({call} call) over buckets "
                f"{list(buckets)}, {' '.join(flags)}: "
                f"{secs:.2f} s | K1 per call {k1_by} (expected "
                f"{want['flow']} per flow bucket, {want['matcha']} per Matcha "
                f"bucket), total {k1}; K2 {k2}")
            stage_s = export_seconds(rec)
            log(f"[export] {call} call, seconds per bucket (export's "
                f"record): " + "; ".join(f"{s} {[round(x, 4) for x in v]}"
                                         for s, v in stage_s.items()))
            for sched, t in rec["serving"].items():
                log(f"[export] {call} call, warm_serving {sched}: "
                    f"{ {k: round(v, 3) for k, v in t.items()} }")
            n = len(buckets)
            lib = build.library_path("flash_attention")
            if any(len(c.get(s, [])) != n for s in
                   ("s3", "flow", "decode", "llm", "matcha", "vocoder")) \
                    or k1_by["flow"] != [want["flow"]] * n \
                    or k1_by["matcha"] != [want["matcha"]] * n \
                    or any(k1_by[s] != [0] * n for s in
                           ("s3", "decode", "llm", "vocoder")) \
                    or len(c.get("serving", [])) != (2 if warm else 0) \
                    or (on_card and warm
                        and not all(x["k1"] > 0 for x in c["serving"])) \
                    or k1 != sum(x["k1"] for v in c.values() for x in v) \
                    or sum(k2.values()) or any(
                        x["k2"] for v in c.values() for x in v) \
                    or (on_card and (not lib.exists() or rec["kernels"]
                                     ["flash_attention"]["path"] != str(lib))):
                raise AssertionError(f"export ({call} call): stage calls "
                                     f"{ {s: len(v) for s, v in c.items()} }, "
                                     f"K1 {k1_by}, K2 {k2}, library {lib}")
            runs.append({"seconds": stage_s, "calls": c, "record": rec})
        log(f"[export] {card} | K1's library {lib} (exists {lib.exists()}, "
            f"built by export {[r['record']['kernels'] for r in runs]})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, second = runs
    return {"launches": {
        "export_buckets": sum(x["k1"] for s in ("s3", "flow", "decode",
                                                "llm")
                              for x in first["calls"].get(s, [])),
        "export_matcha": sum(x["k1"] for s in ("matcha", "vocoder")
                             for x in first["calls"].get(s, [])),
        "export_serving": sum(x["k1"] for x in first["calls"].get(
            "serving", []))},
        "seconds": {call: {s: [round(x, 4) for x in v]
                           for s, v in r["seconds"].items()}
                    for call, r in (("first", first), ("second", second))}}


def export_seconds(rec: dict) -> dict:
    """Each stage's seconds per bucket, in bucket order, from the record
    export.main returns."""
    out = {s: [t[f"{s}_s"] for t in rec["buckets"].values()]
           for s in ("s3", "flow", "decode", "llm")}
    out["matcha"] = [t["synthesise_s"] for t in rec["matcha"].values()]
    out["vocoder"] = [t["vocoder_s"] for t in rec["matcha"].values()]
    return out


# phase 50: the Qwen2 text tokenizer at Qwen2's size
QWEN_REGULAR = 151643   # Qwen2's regular ids: 256 bytes + 151,387 merges
QWEN_ADDED = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")  # 151643-5
QWEN_VOCAB = 151936     # the LM's text embedding (configs/default.yaml)
# the words whose merges come first in the synthetic table (each with and
# without a leading space and capitalised), then Chinese characters
QWEN_WORDS = (
    "the of and to in is you that it he was for on are as with his they "
    "at be this have from or one had by word but not what all were we "
    "when your can said there use an each which she do how their if will "
    "up other about out many then them these so some her would make like "
    "him into time has look two more write go see number no way could "
    "people my than first water been call who its now find long down day "
    "did get come made may part hello world test speech voice text token "
    "model breath laughter quick brown fox jumps over lazy dog").split()
QWEN_HAN = ("你好世界今天天气很不错我们一起去公园散步吧这是一个语音合成的测试"
            "文本中文和英文混合")
QWEN_PUNCT = (".", ",", "!", "?", " (", ")", ".\n", ",\n", "\n\n", "  ",
              "，", "。")
# the strings whose ids phase 50 hashes; QWEN_GOLDEN is the hash of the
# ids transformers' AutoTokenizer gives for them on qwen2_table(), with
# the TTS special tokens added (tests/test_torch_qwen_tokenizer.py holds
# it to the JAX package's QwenTokenizer)
QWEN_GOLDEN_TEXTS = [
    "Hello world, this is a test of the speech model.",
    "It's the quick brown fox; THEY'RE over the lazy dog, I'M sure.",
    "你好世界，今天天气很不错！我们一起去公园散步吧。",
    "<|im_start|>Hello<|im_end|> [breath] voice<|endofprompt|>文本",
    "12345 numbers 3.14 and 1,000,000", "  spaces \t tabs\r\n\r\nlines  ",
    "café naı̈ve \U0001f642\U0001f44d\U0001f3fd こんにちは",
    "[laughter]ha[laughter] <strong>loud</strong> [mm][sigh]"]
QWEN_GOLDEN = ("0d35be5e3a7936fb39d6742d5bb4274c"
               "abb8297f0e39cd57255ee9791c0ec73d")
QWEN_TTS_TEXT = ("Hello world, this is a test of the speech model with the "
                 "quick brown fox.")
QWEN_CLI_TEXT = "你好世界，今天天气很不错，我们一起去公园散步吧。"
QWEN_TIMING_CHARS = 2000


def qwen2_table(n_regular: int = QWEN_REGULAR, seed: int = 0):
    """A seeded Qwen2-sized byte-level BPE table: the 256 byte tokens
    (id = byte), then merges to n_regular ids. Each merge joins two
    tokens already in the table into one it does not hold yet: first the
    chains that spell QWEN_WORDS, QWEN_HAN's characters and pairs, 3,000
    other CJK characters and QWEN_PUNCT, in a seeded order; then random
    pairs of tokens of 16 characters or fewer. Returns (vocab, merges)."""
    import random

    from minimax_speech_torch.infer.qwen_tokenizer import bytes_to_unicode

    rnd = random.Random(seed)
    enc = bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    merges = []

    def add(a, b):
        if a + b not in vocab and len(vocab) < n_regular:
            vocab[a + b] = len(vocab)
            merges.append((a, b))
        return a + b

    words = [v for w in QWEN_WORDS for v in (w, " " + w, w.capitalize(),
                                             " " + w.capitalize())]
    words += list(QWEN_HAN) + [QWEN_HAN[i: i + 2]
                               for i in range(len(QWEN_HAN) - 1)]
    words += [chr(0x4E00 + rnd.randrange(0x5000)) for _ in range(3000)]
    words += list(QWEN_PUNCT)
    rnd.shuffle(words)
    for w in words:
        chars = [enc[b] for b in w.encode("utf-8")]
        cur = chars[0]
        for ch in chars[1:]:
            cur = add(cur, ch)
    toks = list(vocab)
    while len(vocab) < n_regular:
        a, b = toks[rnd.randrange(len(toks))], toks[rnd.randrange(len(toks))]
        if len(a) + len(b) <= 16 and a + b not in vocab:
            toks.append(add(a, b))
    return vocab, merges


def write_qwen2_dir(root, n_regular: int = QWEN_REGULAR, seed: int = 0,
                    layout: str = "tokenizer.json") -> Path:
    """A Qwen2 tokenizer directory of qwen2_table(n_regular, seed), as
    Qwen2's is laid out: QWEN_ADDED at the next ids (special), and
    tokenizer_config.json with Qwen2's fields; the table in tokenizer.json
    (layout "tokenizer.json") or in vocab.json + merges.txt ("vocab")."""
    from minimax_speech_torch.infer.qwen_tokenizer import QWEN2_PAT

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    vocab, merges = qwen2_table(n_regular, seed)
    added = [{"id": len(vocab) + i, "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, t in enumerate(QWEN_ADDED)]
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer",
        "added_tokens_decoder": {str(a["id"]): {
            k: v for k, v in a.items() if k != "id"} for a in added},
        "bos_token": None, "eos_token": QWEN_ADDED[0],
        "pad_token": QWEN_ADDED[0], "unk_token": None,
        "additional_special_tokens": list(QWEN_ADDED[1:]),
        "clean_up_tokenization_spaces": False, "errors": "replace",
        "model_max_length": 32768, "split_special_tokens": False},
        indent=1))
    if layout == "vocab":
        (root / "vocab.json").write_text(json.dumps(vocab,
                                                    ensure_ascii=False))
        (root / "merges.txt").write_text(
            "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
        return root
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    (root / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PAT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab,
                  "merges": [list(m) for m in merges]}},
        ensure_ascii=False))
    return root


def qwen_ids_digest(encode, texts=QWEN_GOLDEN_TEXTS) -> str:
    """sha256 of the ids of `texts`, as JSON."""
    import hashlib
    return hashlib.sha256(json.dumps([list(map(int, encode(t)))
                                      for t in texts]).encode()).hexdigest()


def qwen_timing_texts(n: int = QWEN_TIMING_CHARS, seed: int = 50) -> dict:
    """~n characters each of English, Chinese and mixed text with the TTS
    special tokens, seeded."""
    import random

    from minimax_speech_torch.infer.qwen_tokenizer import SPECIAL_TOKENS

    rnd = random.Random(seed)

    def fill(draw, sep=""):
        out = ""
        while len(out) < n:
            out += draw() + sep
        return out[:n]
    han = [chr(0x4E00 + rnd.randrange(0x5000)) for _ in range(200)] \
        + list(QWEN_HAN)
    return {
        "english": fill(lambda: rnd.choice(QWEN_WORDS) + rnd.choice(
            ["", "", "", ",", "."]), " "),
        "chinese": fill(lambda: rnd.choice(han) + rnd.choice(
            [""] * 9 + ["，", "。"])),
        "mixed": fill(lambda: rnd.choice([
            rnd.choice(QWEN_WORDS).capitalize() + " ", rnd.choice(han),
            rnd.choice(SPECIAL_TOKENS), str(rnd.randrange(1000)), "'s ",
            "\n"]))}


@contextlib.contextmanager
def text_ids_seen():
    """While open, the text ids (before the LM's clamp) of every plan
    SpeechLM.embed_plan embeds, as one list of ints."""
    from minimax_speech_torch.models import llm as llm_mod

    seen, real = [], llm_mod.SpeechLM.embed_plan

    def embed_plan(self, src_type, tok_id, spk_emb):
        seen.extend(tok_id[src_type == llm_mod.SRC_TEXT].tolist())
        return real(self, src_type, tok_id, spk_emb)
    llm_mod.SpeechLM.embed_plan = embed_plan
    try:
        yield seen
    finally:
        llm_mod.SpeechLM.embed_plan = real


def check_text_ids(ids, what: str) -> str:
    """A line on the LM's text ids; raises unless some are above 256 (the
    byte tokenizer's last) and all in [0, QWEN_VOCAB)."""
    line = (f"the LM's text ids {len(ids)}, {sum(i > 256 for i in ids)} "
            f"above 256, range {min(ids, default=None)}-"
            f"{max(ids, default=None)}")
    if not ids or max(ids) <= 256 or max(ids) >= QWEN_VOCAB or min(ids) < 0:
        raise AssertionError(f"{what}: {line}; want some above 256, all "
                             f"under {QWEN_VOCAB}")
    return line


SYNTH_WORKER = "--synth-worker"


def synth_worker(argv) -> int:
    """Phase 50's subprocess, `python chip_smoke.py --synth-worker <cli/
    synthesize.py arguments>`: cli/synthesize.main with K1's and K2's
    launches and the LM's text ids printed at its end."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from minimax_speech_torch.cli import synthesize as synth_cli

    reset_counts()
    with text_ids_seen() as ids:
        audio = synth_cli.main(argv)
    k2, k1 = read_counts()
    print(json.dumps({"synth_worker": {
        "k1": k1, "k2": k2, "samples": len(audio),
        "finite": bool(np.isfinite(audio).all()), "ids": ids}}), flush=True)
    return 0


def qwen_text_phase(card: str, device="cuda", config="configs/default.yaml",
                    lm_layers: int = PATH_LM_LAYERS, max_tokens: int = 100,
                    n_regular: int = QWEN_REGULAR, golden=True) -> dict:
    """Phase 50: a synthetic Qwen2 directory at Qwen2's size
    (write_qwen2_dir) read by QwenTokenizer on the standard-library
    path (`regex` hidden): load seconds, encode chars/s on
    qwen_timing_texts, the ids of QWEN_GOLDEN_TEXTS against QWEN_GOLDEN
    (golden=False skips it, for a smaller table); then at the widths of
    `config` (W8A8 LM in bf16 at lm_layers, random weights, seed 0)
    TTS(pipeline=..., tokenizer_path=dir).inference_zero_shot and
    cli/synthesize.py --tokenizer_path dir in a subprocess: the LM's text
    ids above 256 and under QWEN_VOCAB, K1 560 launches per utterance, K2
    0. Returns {"launches": {path: K1 per utterance}, "load_s",
    "chars_per_s"}."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.infer import qwen_tokenizer as qt
    from minimax_speech_torch.infer.api import TTS
    from minimax_speech_torch.infer.pipeline import TTSPipeline

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="qwen2_", dir=repo / "build"))
    try:
        t0 = time.perf_counter()
        d = write_qwen2_dir(root / "tok", n_regular)
        write_s = time.perf_counter() - t0
        hidden = sys.modules.get("regex")
        sys.modules["regex"] = None  # the card's machine has no regex
        try:
            t0 = time.perf_counter()
            tok = qt.QwenTokenizer(str(d))
            load_s = time.perf_counter() - t0
            if tok._split is not qt.split_qwen2:
                raise AssertionError("the stdlib splitter was not taken")
            rate = {}
            for name, text in qwen_timing_texts().items():
                t0 = time.perf_counter()
                ids = tok.encode(text)
                rate[name] = len(text) / (time.perf_counter() - t0)
                if name != "mixed" and tok.decode(ids) != text:
                    raise AssertionError(f"{name}: decode(encode) differs")
            digest = qwen_ids_digest(tok.encode)
        finally:
            if hidden is None:
                sys.modules.pop("regex", None)
            else:
                sys.modules["regex"] = hidden
        log(f"[qwen] {card} | synthetic Qwen2 table: {len(tok.vocab)} "
            f"regular ids, {len(tok.added)} added, the last id "
            f"{tok.vocab_size - 1}; tokenizer.json written in {write_s:.2f} "
            f"s, read in {load_s:.2f} s; encode on the stdlib splitter, "
            f"first pass, chars/s "
            f"{ {k: round(v) for k, v in rate.items()} }; golden ids "
            f"{digest[:16]} (want {QWEN_GOLDEN[:16]})")
        if golden and digest != QWEN_GOLDEN:
            raise AssertionError("the ids of QWEN_GOLDEN_TEXTS differ from "
                                 "transformers'")

        cfg = cfg_lib.load_tts_config(repo / config, [
            "model.lm.qwen.quantized=true",
            f"model.lm.qwen.n_layers={lm_layers}",
            f"model.max_speech_tokens={max_tokens}"])
        per_utt = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
        want = per_utt if torch.device(device).type == "cuda" else 0
        pipe = TTSPipeline.from_random(cfg, seed=0, device=device)
        pipe.lm.to(torch.bfloat16)
        tts = TTS(pipeline=pipe, tokenizer_path=str(d))
        if not isinstance(tts.frontend.tokenizer, qt.QwenTokenizer):
            raise AssertionError("TTS(tokenizer_path=dir) took "
                                 f"{type(tts.frontend.tokenizer)}")
        prompt = speechlike(np.random.default_rng(50),
                            int(PROMPT_SECONDS * 16000), 16000)
        pieces = tts.frontend.text_normalize(QWEN_TTS_TEXT)
        cli_pieces = len(tts.frontend.text_normalize(QWEN_CLI_TEXT))
        reset_counts()
        sync(device)
        t0 = time.perf_counter()
        with text_ids_seen() as ids:
            wav = np.concatenate([o["tts_speech"] for o in
                                  tts.inference_zero_shot(
                                      QWEN_TTS_TEXT, "a reference", prompt)],
                                 axis=1)
        sync(device)
        total_s = time.perf_counter() - t0
        k2, k1 = read_counts()
        log(f"[qwen] {card} | TTS(pipeline, tokenizer_path) zero-shot, W8A8 "
            f"LM in bf16 at {lm_layers} layers: {len(pieces)} piece(s), "
            f"{wav.shape[1] / 24000:.2f} s of audio in {total_s:.2f} s; "
            f"{check_text_ids(ids, 'TTS zero-shot')}; K1 launches {k1} "
            f"(expected {want * len(pieces)}), K2 {k2}")
        if k1 != want * len(pieces) or sum(k2.values()) \
                or wav.shape[1] == 0 or not np.isfinite(wav).all():
            raise AssertionError(f"TTS zero-shot on Qwen2 text: K1 {k1}, "
                                 f"K2 {k2}, {wav.shape}")
        del tts, pipe
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()

        argv = ["--random_init", "--config", str(repo / config), "--device",
                device, "--out", str(root / "cli.wav"), "--text",
                QWEN_CLI_TEXT, "--tokenizer_path", str(d),
                "--override", "model.lm.qwen.quantized=true",
                "--override", f"model.max_speech_tokens={max_tokens}",
                "--override", f"model.lm.qwen.n_layers={lm_layers}"]
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, str(repo / "chip_smoke.py"), SYNTH_WORKER,
             *argv], capture_output=True, text=True, timeout=600, cwd=repo)
        cli_s = time.perf_counter() - t0
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith('{"synth_worker"')]
        if res.returncode or not lines:
            raise AssertionError(f"cli/synthesize.py --tokenizer_path: rc "
                                 f"{res.returncode}\n{res.stdout[-2000:]}"
                                 f"\n{res.stderr[-4000:]}")
        w = json.loads(lines[-1])["synth_worker"]
        log(f"[qwen] {card} | cli/synthesize.py --tokenizer_path in a "
            f"subprocess, {cli_s:.1f} s: {w['samples'] / 24000:.2f} s of "
            f"audio, {cli_pieces} piece(s); "
            f"{check_text_ids(w['ids'], 'cli/synthesize.py')}; K1 "
            f"{w['k1']} (expected {want * cli_pieces}), K2 {w['k2']}")
        if w["k1"] != want * cli_pieces or sum(w["k2"].values()) \
                or not w["samples"] or not w["finite"]:
            raise AssertionError(f"cli/synthesize.py on Qwen2 text: {w}")
        return {"launches": {"qwen_text_zero_shot": want,
                             "qwen_text_synth_cli": want},
                "load_s": round(load_s, 4),
                "chars_per_s": {k: round(v) for k, v in rate.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 51, the learn-and-speak path (cli/overfit_pipeline.py) at the
# proof's geometry. OFIT_BUDGET: 2 utterances (2 x 1.2 s), each stage's
# steps enough for two logged losses (logged every 50 steps: the DAC's
# from step 0), so that the fall shows; the DAC's iterations cost ~0.54
# s each on an H100 80GB HBM3 at 700 W (PERF.md), the flow's steps ~0.13
# s, the LM's ~0.07 s. OFIT_LM16_EPOCHS: the LM stage again at
# --lm_hidden 64 (heads of 16)
OFIT_BUDGET = dict(n_utts=2, dac_iters=60, flow_epochs=100,
                   flow_polish_epochs=20, llm_epochs=100)
OFIT_LM16_EPOCHS = 100
# the card's evaluate against the CPU's on one model directory and the
# same flow draws: float32 in other summation orders (TF32 off) through
# the conformer, 10 Euler steps of the UNet (K1 against the plain
# attention) and the codec's decode, relative on the flow's errors and
# the mel loss, absolute on the codec's SNR (dB) and correlation
OFIT_EVAL_TOL = {"flow_mse": (1e-3, 0.0), "flow_nmse": (1e-3, 0.0),
                 "flow_nmse_mean4": (1e-3, 0.0),
                 "mel_spectral_loss": (1e-3, 0.0),
                 "dac_snr_db": (0.0, 1e-2), "dac_corr": (0.0, 1e-4)}
# ... and the LM decode's, on the same host noise: the same tokens (as
# phase 5 holds the decode), so these agree exactly
OFIT_EVAL_EXACT = ("token_match", "token_match_w8a8", "gen_len",
                   "token_len_err")
# phase 51 holds K1 and K2 against their plain versions at every (shape,
# key lengths, mask) that the chain gave them (kernel_shapes), after it;
# these ragged cases, in every mask mode, go first as extras: a T that is
# not a multiple of the 64-row tiles, batch rows of other lengths, and K1
# at head dim 16
OFIT_K1_CASES = [((2, 2, 77, 8), (77, 40)), ((2, 2, 128, 16), (128, 100))]
OFIT_K2_CASES = [((2, 4, 150, 8), (150, 131)), ((2, 4, 150, 16), (150, 131)),
                 ((2, 8, 77, 8), (77, 40))]


@contextlib.contextmanager
def kernel_shapes():
    """Until exit, the launches of K1 and K2's forward counted by (B, H, T,
    D, dtype), and by what else each got: {"k1": {key: n}, "k2": {key: n},
    "k1_cases": {(key, kv_len, chunk, left_chunks): n}, "k2_cases": the
    same for K2}. K1 is counted at its one model caller, the UNet
    (models/decoder_unet.py), where its key lengths are at hand."""
    import torch

    from minimax_speech_torch.kernels import splash
    from minimax_speech_torch.models import decoder_unet

    seen = {"k1": {}, "k2": {}, "k1_cases": {}, "k2_cases": {}}
    k1_fn, k2_fwd = decoder_unet.flash_attention, splash._kernel_forward

    def count(kernel, q, kv_len, chunk, left):
        key = (*q.shape, "bf16" if q.dtype == torch.bfloat16 else "fp32")
        kv = (q.shape[2],) * q.shape[0] if kv_len is None \
            else tuple(kv_len.tolist())
        case = (key, kv, int(chunk), int(left))
        seen[kernel][key] = seen[kernel].get(key, 0) + 1
        cases = seen[kernel + "_cases"]
        cases[case] = cases.get(case, 0) + 1

    def k1_wrapped(q, k, v, kv_len=None, chunk=0, left_chunks=-1, **kw):
        if q.device.type == "cuda":
            count("k1", q, kv_len, chunk, left_chunks)
        return k1_fn(q, k, v, kv_len, chunk, left_chunks, **kw)

    def k2_wrapped(q, k, v, kv_len, chunk, left_chunks):
        count("k2", q, kv_len, chunk, left_chunks)
        return k2_fwd(q, k, v, kv_len, chunk, left_chunks)

    decoder_unet.flash_attention = k1_wrapped
    splash._kernel_forward = k2_wrapped
    try:
        yield seen
    finally:
        decoder_unet.flash_attention = k1_fn
        splash._kernel_forward = k2_fwd


def path_agreement(seen, gen) -> dict:
    """K1 and K2 against their plain versions at every (shape, key
    lengths, mask) of `seen` (kernel_shapes), fp32 and bf16 as
    k1_agreement and k2_agreement hold them, whichever dtype the path ran.
    Returns {"k1": {shape: err}, "k2": {shape: err}}: the largest fp32
    error over each (B, H, T, D)'s cases."""
    errs = {"k1": {}, "k2": {}}
    for kernel, check in (("k1", k1_agreement), ("k2", k2_agreement)):
        cases = sorted({(key[:4], kv, chunk, left) for key, kv, chunk, left
                        in seen[kernel + "_cases"]})
        for shape, kv, chunk, left in cases:
            names = [n for n, m in K2_MODES.items() if m == (chunk, left)]
            name = names[0] if names else f"chunk{chunk}_left{left}"
            mode = (dict(chunk=chunk, left_chunks=left) if kernel == "k1"
                    else (chunk, left))
            err = check([(shape, kv)], {name: mode}, gen)
            errs[kernel][shape] = max(errs[kernel].get(shape, 0.0), err)
        log(f"[ofit] {kernel} held against its plain version at the "
            f"path's {len(cases)} (shape, key lengths, mask) cases")
    return errs


def logged(path: Path, key: str) -> list:
    """The values of `key` in a metrics JSONL, in order."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r[key] for r in rows if key in r]


def overfit_phase(card: str, device="cuda", budget=OFIT_BUDGET,
                  lm16_epochs: int = OFIT_LM16_EPOCHS,
                  config="configs/tiny.yaml") -> dict:
    """Phase 51 (the module comment above it and the docstring at the
    top). Returns {"kernels": the kernels line's entries at head dims 8
    and 16 (empty on the CPU), "stages": each stage's seconds and
    launches, "metrics", "cpu_metrics", "bf16", "metrics_lm16"}."""
    import shutil
    import tempfile

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.cli import eval_bf16_flow as bf16_cli
    from minimax_speech_torch.cli import overfit_pipeline as ofp
    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.kernels import splash

    cuda = device == "cuda"
    if cuda:
        gen = torch.Generator(device="cuda").manual_seed(51)
        k1_agreement(OFIT_K1_CASES, MODES, gen)
        k2_agreement(OFIT_K2_CASES, K2_MODES, gen)
    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ofit_", dir=repo / "build"))
    try:
        wd, stages = root / "w", {}
        fa.launches = 0
        splash.launches.update(forward=0, backward=0)
        with kernel_shapes() as seen:
            t0 = time.perf_counter()
            metrics = ofp.run(wd, config=str(repo / config), device=device,
                              stats=stages, **budget)
            chain_s = time.perf_counter() - t0
        k1_total = fa.launches
        k2_total = dict(splash.launches)
        cfg = cfg_lib.load_tts_config(wd / "model" / "config.yaml")
        u = cfg.flow.unet
        per_flow_step = attn_calls_per_step(u)
        per_lm_step = cfg.lm.qwen.n_layers
        per_flow_call = per_flow_step * cfg.flow.n_timesteps
        # 4 flow draws and 2 zero-shot syntheses in evaluate
        want = {"extract_fsq": (0, 0), "train_dac": (0, 0),
                "extract_dac_latents": (0, 0),
                "train_flow": (0, budget["flow_epochs"] * per_flow_step),
                "train_flow_polish": (
                    0, budget["flow_polish_epochs"] * per_flow_step),
                "train_llm": (0, budget["llm_epochs"] * per_lm_step),
                "evaluate": (6 * per_flow_call, 0)}
        if not cuda:
            want = {k: (0, 0) for k in want}
        for stage, (k1, k2) in want.items():
            st = stages[stage]
            log(f"[ofit] {card} | {stage}: {st['s']:.2f} s, K1 {st['k1']}, "
                f"K2 {st['k2_fwd']} + {st['k2_bwd']} (expected {k1}, "
                f"{k2} + {k2})")
            if (st["k1"], st["k2_fwd"], st["k2_bwd"]) != (k1, k2, k2):
                raise AssertionError(f"phase 51 {stage}: launches {st}, "
                                     f"expected K1 {k1}, K2 {k2} + {k2}")
        for exp, key in (("exp_dac/dac", "gen/loss"), ("exp_flow/flow", "loss"),
                         ("exp_llm/llm", "loss")):
            vals = logged(wd / f"{exp}_metrics.jsonl", key)
            log(f"[ofit] {exp} {key} logged {[round(v, 4) for v in vals]}")
            if len(vals) < 2 or not vals[-1] < vals[0]:
                raise AssertionError(f"phase 51: {exp} {key} did not fall: "
                                     f"{vals}")
        show = {k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in metrics.items()}
        log(f"[ofit] {card} | chain {chain_s:.1f} s, metrics {show}")
        if not all(np.isfinite(v) for k, v in metrics.items()
                   if not k.startswith("llm_train")):
            raise AssertionError(f"phase 51 metrics: {metrics}")

        # the same model directory on the CPU: its flow draws and decode
        # noise are host noise, the card's numbers
        meta = ofp.make_corpus(wd / "corpus", n_utts=budget["n_utts"])
        t0 = time.perf_counter()
        cpu = ofp.evaluate(wd / "model", wd / "corpus", meta, device="cpu")
        bad = [k for k in OFIT_EVAL_EXACT if metrics[k] != cpu[k]]
        log(f"[ofit] card vs CPU, exact: "
            f"{ {k: (metrics[k], cpu[k]) for k in OFIT_EVAL_EXACT} }")
        for key, (rtol, atol) in OFIT_EVAL_TOL.items():
            diff = abs(metrics[key] - cpu[key])
            ok = diff <= atol + rtol * abs(cpu[key])
            log(f"[ofit] card vs CPU {key}: {metrics[key]:.6g} / "
                f"{cpu[key]:.6g}, |diff| {diff:.2e} (tol {atol:g} + "
                f"{rtol:g} * |cpu|) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(key)
        log(f"[ofit] the CPU's evaluate {time.perf_counter() - t0:.1f} s")
        if bad:
            raise AssertionError(f"phase 51 card vs CPU: {bad}")

        # the bf16 flow A/B on the same weights
        k1_before = fa.launches
        with kernel_shapes() as seen_bf16:
            bf16 = bf16_cli.evaluate(wd, device=device)
        log(f"[ofit] {card} | eval_bf16_flow {bf16}, K1 "
            f"{fa.launches - k1_before} ({seen_bf16['k1']})")
        if cuda and not any(k[-1] == "bf16" for k in seen_bf16["k1"]):
            raise AssertionError("phase 51: the bf16 flow did not run K1 "
                                 "in bf16")
        if not bf16["latent_rel_err"] < 0.05:
            raise AssertionError(f"phase 51 bf16 flow: {bf16}")

        # the LM stage again at --lm_hidden 64 (heads of 16), every other
        # stage's outputs copied (stage-level resume skips them)
        wd16 = root / "w16"
        shutil.copytree(wd / "corpus", wd16 / "corpus")
        shutil.copytree(wd / "model", wd16 / "model",
                        ignore=shutil.ignore_patterns("llm.npz"))
        shutil.copytree(wd / "exp_flow", wd16 / "exp_flow",
                        ignore=shutil.ignore_patterns("ckpt"))
        stages16 = {}
        fa.launches = 0
        splash.launches.update(forward=0, backward=0)
        with kernel_shapes() as seen16:
            metrics16 = ofp.run(wd16, config=str(repo / config),
                                device=device, stats=stages16, lm_hidden=64,
                                **{**budget, "llm_epochs": lm16_epochs})
        k2_16 = dict(splash.launches)
        st = stages16["train_llm"]
        k2_want = lm16_epochs * per_lm_step if cuda else 0
        vals = logged(wd16 / "exp_llm/llm_metrics.jsonl", "loss")
        log(f"[ofit] {card} | --lm_hidden 64: stages {sorted(stages16)}, "
            f"train_llm {st['s']:.2f} s, K2 {st['k2_fwd']} + "
            f"{st['k2_bwd']} (expected {k2_want} each), loss logged "
            f"{[round(v, 4) for v in vals]}, token_match "
            f"{metrics16['token_match']:.4f}")
        if set(stages16) != {"train_llm", "evaluate"} \
                or (st["k2_fwd"], st["k2_bwd"]) != (k2_want, k2_want) \
                or len(vals) < 2 or not vals[-1] < vals[0]:
            raise AssertionError(f"phase 51 --lm_hidden 64: {stages16}, "
                                 f"loss {vals}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"stages": stages, "metrics": metrics, "cpu_metrics": cpu,
           "bf16": bf16, "metrics_lm16": metrics16, "kernels": []}
    if not cuda:
        return out

    # every launch of the chain at the head dims its shapes have
    def by_dim(counts, d):
        return sum(n for key, n in counts.items() if key[3] == d)
    if by_dim(seen["k1"], 8) != k1_total \
            or 2 * by_dim(seen["k2"], 8) != sum(k2_total.values()) \
            or 2 * by_dim(seen16["k2"], 16) != sum(k2_16.values()):
        raise AssertionError(f"phase 51 head dims: K1 {seen['k1']}, K2 "
                             f"{seen['k2']}, {seen16['k2']}")
    log(f"[ofit] shapes: K1 {seen['k1']}; K2 {seen['k2']}; K2 at "
        f"--lm_hidden 64 {seen16['k2']}")
    # each kernel against its plain version at the shapes, key lengths
    # and masks that the chain gave it
    gen = torch.Generator(device="cuda").manual_seed(53)
    errs = path_agreement(seen, gen)
    errs["k2"].update(path_agreement(seen16, gen)["k2"])

    # times at the path's shapes, as phases 3 and 6 take them
    gen = torch.Generator(device="cuda").manual_seed(52)
    # each at its most launched shape, with that shape's most launched key
    # lengths: K1 at the evaluation's flow draws, K2 at each training path's
    def most(cases, key):
        return max((c for c in cases if c[0] == key), key=cases.get)[1]
    k1_key = max(seen["k1"], key=seen["k1"].get)
    k1_rec = k1_timing(gen, k1_key[:4], most(seen["k1_cases"], k1_key))
    entries = [{"name": "flash_attention_d8", "route": "cuda",
                "source": "minimax_speech_torch/csrc/flash_attention.cu",
                "replaces": "minimax_speech_tpu/kernels/flash_attention.py:114",
                "launches": k1_total,
                "max_abs_err": max(errs["k1"].values()), **k1_rec}]
    for name, counts in (
            ("splash_attention_d8_flow", {k: n for k, n in seen["k2"].items()
                                          if k[1] == u.num_heads}),
            ("splash_attention_d8_lm", {k: n for k, n in seen["k2"].items()
                                        if k[1] == cfg.lm.qwen.n_heads}),
            ("splash_attention_d16_lm", seen16["k2"])):
        key = max(counts, key=counts.get)
        kv = most(seen16["k2_cases"] if "d16" in name else seen["k2_cases"],
                  key)
        mode = "full" if "flow" in name else "causal"
        rec = k2_timing(gen, key[:4], kv, mode)
        entries.append({
            "name": name, "route": "cuda",
            "source": "minimax_speech_torch/csrc/splash_attention.cu",
            "replaces": "minimax_speech_tpu/kernels/splash.py:92",
            "launches": 2 * sum(counts.values()),
            "max_abs_err": errs["k2"][key[:4]], **rec})
    out["kernels"] = entries
    return out


def tf32_off():
    """fp32 matmuls and convolutions without TF32, in this process (the
    main one, or a rank of phases 32-33's gang)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# phases 5 and 8-51 run in STREAMS: three processes at once on the one
# card (this one and two workers), each a list of phases in order, once
# the quiet phases 1-4, 6 and 7 have given the kernels line its times.
# Their own times carry the other streams' load on the card and the host;
# torch's CPU threads are shared among them (stream_threads). A worker's
# log is printed whole when it ends
STREAMS = ("synthesis", "lm_train", "flow_gan")
STREAM_WORKER = "--stream-worker"
# the lock file that `heavy` holds, named in the streams' environment
HEAVY_LOCK = "CHIP_SMOKE_HEAVY_LOCK"


@contextlib.contextmanager
def heavy(what: str):
    """Held around the phases whose device memory peaks above ~15 GiB
    (the DAC GAN's 38.9 GiB, the 24-layer LM steps' 16-17 GiB, the image
    track's 23.8, the ranks' two processes): one at a time among the
    streams, so that one of them and the other streams' lighter phases
    fit in the card's 80 GB together. The cached blocks are freed before
    the next may start. Outside run_streams (no HEAVY_LOCK), nothing."""
    path = os.environ.get(HEAVY_LOCK)
    if not path:
        yield
        return
    import fcntl
    import gc

    import torch

    with open(path, "a") as lock:
        t0 = time.perf_counter()
        fcntl.flock(lock, fcntl.LOCK_EX)
        waited = time.perf_counter() - t0
        if waited > 0.5:
            log(f"[heavy] {what}: waited {waited:.1f} s for another "
                f"stream's heavy phase")
        try:
            yield
        finally:
            gc.collect()
            torch.cuda.empty_cache()
            fcntl.flock(lock, fcntl.LOCK_UN)


def stream_threads() -> int:
    """torch's CPU threads in each stream: the cores this process may
    run on, shared among STREAMS."""
    return max(2, len(os.sched_getaffinity(0)) // len(STREAMS))


def synthesis_cfg():
    """The synthesis configuration of phases 3-5 and 10-18: TTSConfig()
    at GEN_TOKENS, the LM as bench.py builds it: W8A8 projections with
    random int8 kernels (bf16 elsewhere in phase 4)."""
    from minimax_speech_torch.infer.pipeline import TTSConfig

    train_lm = TTSConfig().lm
    cfg = fixed_length(TTSConfig(), GEN_TOKENS)
    return dataclasses.replace(cfg, lm=dataclasses.replace(
        train_lm, qwen=dataclasses.replace(train_lm.qwen, quantized=True)))


def stream_synthesis(card: str, shared: dict) -> dict:
    """Phases 5, 10-18 (synthesis, streaming, serving), 39-44 (CAM++,
    codec file, transforms, Matcha, legacy), 49 (export) and 50 (Qwen2
    text).
    Returns the kernels line's updates, {"record": ..., "k2": ...}."""
    import torch

    from minimax_speech_torch.infer.pipeline import TTSPipeline

    t0 = time.perf_counter()
    cfg, inputs = synthesis_cfg(), prompts()
    h, d = cfg.flow.unet.num_heads, cfg.flow.unet.attention_head_dim
    pipes = reduced_pipes(cfg, inputs)
    cross_check(pipes, inputs)
    w8a8_cross_check(cfg, pipes, inputs)
    del pipes
    t0 = phase_time(5, t0)

    w8a8_checks(cfg.lm.qwen, card)
    t0 = phase_time(10, t0)
    pipe = TTSPipeline.from_random(shallow_lm(cfg), seed=0, device="cuda")
    pipe.lm.to(torch.bfloat16)
    paths, shapes, _ = stream_main_path(pipe, inputs, card)
    del pipe
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1)
    record = {"launches_by_path": paths, "at_streaming_shapes": {}}
    for path, ((bb, tt), kv_s) in shapes.items():
        chunk = cfg.flow.unet.static_chunk_size if "chunk50" in path else 0
        record["at_streaming_shapes"][path] = k1_timing(
            gen, (bb, h, tt, d), kv_s, chunk)
    t0 = phase_time(11, t0)
    stream_cross_check(reduced_pipes(cfg, inputs), inputs)
    t0 = phase_time(12, t0)
    synth_cli_phase()
    t0 = phase_time(13, t0)

    # serving: phases 15 and 16, then 14 at the shapes they gave K1
    pipe = TTSPipeline.from_random(shallow_lm(fixed_length(cfg,
                                                           SERVE_TOKENS)),
                                   seed=0, device="cuda")
    pipe.lm.to(torch.bfloat16)
    reqs = serve_requests(pipe, SERVE_SPECS)
    batch_launches, batch_seen = serve_batch_phase(pipe, reqs[:4], card)
    t0 = phase_time(15, t0)
    hop_launches, hop_seen = serve_stream_phase(pipe, reqs, card)
    t0 = phase_time(16, t0)
    paths.update(serve_batch=batch_launches[0], **hop_launches)
    record["at_serving_shapes"] = serving_k1_phase(
        batch_seen, hop_seen, h, d, cfg.flow.unet.static_chunk_size)
    t0 = phase_time(14, t0)
    serve_cli_phase()
    warm_phase(pipe, card)
    del pipe
    torch.cuda.empty_cache()
    t0 = phase_time(17, t0)
    serve_cross_check(reduced_pipes(cfg, inputs))
    t0 = phase_time(18, t0)

    xvector = campplus_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(39, t0)
    codec_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(40, t0)
    transforms_phase(card)
    t0 = phase_time(41, t0)

    # Matcha-TTS and the legacy CosyVoice1 flow and LM: phases 42-44
    matcha = matcha_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(42, t0)
    matcha_train = matcha_train_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(43, t0)
    legacy = legacy_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(44, t0)

    export_rec = export_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(49, t0)
    qwen = qwen_text_phase(card)
    torch.cuda.empty_cache()
    phase_time(50, t0)

    zeros = {"codec_file_cli": 0, "transforms_and_train_dac": 0}
    paths.update(
        **zeros, **matcha["launches"], matcha_train_cli=0,
        xvector_zero_shot=xvector["launches"],
        legacy_flow_inference=legacy["launches"]["legacy_flow_inference"],
        legacy_flow_loss=0, **export_rec["launches"], **qwen["launches"])
    record.update(at_matcha_shapes=matcha["k1"],
                  at_legacy_shapes=legacy["k1"],
                  export_s=export_rec["seconds"],
                  qwen_text={k: qwen[k] for k in ("load_s", "chars_per_s")})
    k2 = {"launches_by_path": {
        **zeros, "matcha_cli_unbatched": 0, "matcha_cli_batched": 0,
        "xvector_zero_shot": 0,
        **matcha_train["launches"], "legacy_flow_inference": 0,
        "legacy_flow_loss": legacy["launches"]["legacy_flow_loss"],
        **{p: 0 for p in export_rec["launches"]},
        **{p: 0 for p in qwen["launches"]}},
        "per_step_by_path": {"matcha_train_cli": matcha_train["per_step"]},
        "at_matcha_train_shapes": matcha_train["k2"],
        "at_legacy_train_shapes": legacy["k2"],
        "matcha_step_ms": matcha_train["step_ms"],
        "matcha_mas_ms": matcha_train["mas_ms"]}
    return {"record": record, "k2": k2}


def stream_lm_train(card: str, shared: dict) -> dict:
    """Phases 8 and 9 (the LM's training CLI, card vs CPU), 28-31 (remat,
    DPO), 32-34 (training over two ranks) and 51 (the learn-and-speak
    path, whose kernel entries it returns under "kernels").
    `shared["lm_off"]` is phase 7's remat-off record."""
    import torch

    from minimax_speech_torch.infer.pipeline import TTSConfig
    from minimax_speech_torch.utils.gang import Gang

    t0 = time.perf_counter()
    train_lm = TTSConfig().lm
    q = train_lm.qwen
    batch = lm_batch(train_lm)
    cli_phase(lm_layers=PATH_LM_LAYERS)
    t0 = phase_time(8, t0)
    train_cross_check(train_lm, batch)
    torch.cuda.empty_cache()
    t0 = phase_time(9, t0)

    with heavy("phase 28"):
        remat_rec = remat_phase(train_lm, batch, card,
                                off=shared["lm_off"])
    t0 = phase_time(28, t0)
    dbatch = dpo_batch(train_lm)
    dpo_rec = dpo_phase(shallow_lm(TTSConfig()).lm, dbatch, card)
    torch.cuda.empty_cache()
    t0 = phase_time(29, t0)
    dpo_cross_check(train_lm, dbatch)
    torch.cuda.empty_cache()
    t0 = phase_time(30, t0)
    cli_phase(dpo=True, resume=False, lm_layers=PATH_LM_LAYERS)
    cli_phase(remat="dots", resume=False, lm_layers=PATH_LM_LAYERS)
    t0 = phase_time(31, t0)

    # training over two ranks: phases 32-34, each timed; world size 1
    # runs here while the gang's ranks start, before the gang's first job
    flow_cfg = TTSConfig().flow
    fbatch = flow_batch(flow_cfg)
    u = flow_cfg.unet
    backend = dist_backend()
    initial = Path(__file__).resolve().parent / "build" / "dist_lm.pt"
    with heavy("phases 32-33"):
        gang = Gang(2, "chip_smoke", backend, "cuda")
        try:
            world1_phase(train_lm, batch)
            torch.cuda.empty_cache()
            # the ranks' LM and DPO jobs at PATH_LM_LAYERS of 24 layers,
            # full widths (K2's shapes per rank are the full model's),
            # from phase 31's weights (as lm_module asks for them: a
            # cache hit), which the ranks read in place of running the
            # initialiser
            dist_cfg = shallow_lm(TTSConfig()).lm
            initial.parent.mkdir(parents=True, exist_ok=True)
            torch.save(lm_weights(remat_lm(dist_cfg, "off"), 0, None),
                       initial)
            lm_weights.cache_clear()
            log(f"[time] phase 32, world size 1 with the ranks' start-up "
                f"and the weights' file: {time.perf_counter() - t0:.1f} s")
            dist_lm = dist_phase(gang, "lm", dist_cfg, batch, card, backend,
                                 weights=str(initial))
            dist_dpo = dist_phase(
                gang, "dpo", dist_cfg,
                {k: v[:DPO_CROSS_BATCH] for k, v in dbatch.items()}, card,
                backend, meshes=((1, 2),), steps_n=2)
            lens = [int(n) for n in batch["seq_len"]]
            at_dist = dist_k2_phase([
                ("lm_tp2", (LM_BATCH, q.n_heads // 2, LM_PAD, q.head_dim),
                 lens, "causal"),
                ("lm_dp2", (LM_BATCH // 2, q.n_heads, LM_PAD, q.head_dim),
                 lens[:LM_BATCH // 2], "causal")])
            t0 = phase_time(32, t0)
            dist_flow = dist_phase(gang, "flow", flow_cfg, fbatch, card,
                                   backend,
                                   symmetric=flow_symmetric(flow_cfg),
                                   steps_n=FLOW_DIST_STEPS)
            t_f = fbatch["feat"].shape[1]
            lens = [int(n) for n in fbatch["feat_len"]]
            at_dist.update(dist_k2_phase([
                ("flow_tp2", (FLOW_BATCH, u.num_heads // 2, t_f,
                              u.attention_head_dim), lens, "full"),
                ("flow_dp2", (FLOW_BATCH // 2, u.num_heads, t_f,
                              u.attention_head_dim),
                 lens[:FLOW_BATCH // 2], "full")]))
            t0 = phase_time(33, t0)
        finally:
            gang.close()
            initial.unlink(missing_ok=True)
    launch_rec = launch_phase(card, backend)
    t0 = phase_time(34, t0)
    ofit = overfit_phase(card)
    phase_time(51, t0)

    # totals over the timed steps, as lm_train's; per step beside them
    runs = {f"lm_train_remat_{m}": r for m, r in remat_rec.items()}
    runs.update({f"dpo_train_remat_{m}": r for m, r in dpo_rec.items()})
    k2 = {"launches_by_path": {p: r["launches"] for p, r in runs.items()},
          "per_step_by_path": {p: r["per_step"] for p, r in runs.items()},
          "at_dist_shapes": at_dist}
    # per rank, over each run's steps
    for rec in (dist_lm, dist_dpo, dist_flow):
        k2["launches_by_path"].update({
            p: int(sum(v.values()) * rec["steps"])
            for p, v in rec["per_step"].items()})
        k2["per_step_by_path"].update(rec["per_step"])
    k2["launches_by_path"]["lm_train_cli_launch_tp2"] = \
        launch_rec["launches"]
    k2["per_step_by_path"]["lm_train_cli_launch_tp2"] = \
        launch_rec["per_step"]
    k2["dist_step_s_per_rank"] = {**dist_lm["step_s"],
                                  **dist_flow["step_s"]}
    return {"record": {}, "k2": k2, "kernels": ofit["kernels"]}


def stream_flow_gan(card: str, shared: dict) -> dict:
    """Phases 19-22 (flow training), 23-27 (the mel output mode), 35-38
    (codec and vocoder GAN training, extraction) and 45-48 (flowae)."""
    import torch

    from minimax_speech_torch.infer.pipeline import TTSConfig, TTSPipeline

    t0 = time.perf_counter()
    cfg, inputs = synthesis_cfg(), prompts()
    # flow training: phase 19 at the shapes of phase 20's batch, then 20-22
    flow_cfg = TTSConfig().flow
    fbatch = flow_batch(flow_cfg)
    u = flow_cfg.unet
    k2 = {"at_flow_train_shapes": flow_k2_phase(
        (FLOW_BATCH, u.num_heads, fbatch["feat"].shape[1],
         u.attention_head_dim), [int(n) for n in fbatch["feat_len"]])}
    t0 = phase_time(19, t0)
    flow_rec = flow_train_phase(flow_cfg, fbatch, card)
    torch.cuda.empty_cache()
    t0 = phase_time(20, t0)
    k2["launches_by_path"] = {"flow_train": flow_rec.pop("flow_train")}
    k2.update(flow_rec)
    cli_phase(model="flow")
    t0 = phase_time(21, t0)
    flow_cross_check(flow_cfg, fbatch)
    t0 = phase_time(22, t0)

    # the mel output mode (HiFT): phases 23-27
    mel_cfg = dataclasses.replace(cfg, output_type="mel")
    hift_rec = hift_phase(mel_cfg.hift, card)
    t0 = phase_time(23, t0)
    pipe = TTSPipeline.from_random(shallow_lm(mel_cfg), seed=0,
                                   device="cuda")
    pipe.lm.to(torch.bfloat16)
    voice(pipe.hift, HIFT_SEED)
    paths = mel_synthesis_phase(pipe, inputs, card)
    t0 = phase_time(24, t0)
    paths["mel_serve_batch"] = mel_serve_phase(pipe, card)
    del pipe
    torch.cuda.empty_cache()
    t0 = phase_time(25, t0)
    pipes = reduced_pipes(mel_cfg, inputs)
    for p in pipes[1:3]:  # phase 23's HiFT, whose gaps set the PCM limit
        p.hift.load_state_dict(hift_rec["state"])
    cross_check(pipes, inputs, hift_gaps=hift_rec["gaps"])
    t0 = phase_time(26, t0)
    convert_phase(pipes, inputs, card)
    del pipes
    torch.cuda.empty_cache()
    t0 = phase_time(27, t0)

    # codec and vocoder GAN training, extraction: phases 35-38
    with heavy("phases 35-36"):
        gan_train_phase("dac", TTSConfig().dac, card)
        torch.cuda.empty_cache()
        t0 = phase_time(35, t0)
        gan_train_phase("hift", TTSConfig().hift, card)
    t0 = phase_time(36, t0)
    gan_cross_check("dac", TTSConfig().dac)
    gan_cross_check("hift", TTSConfig().hift)
    v1_cross_check()
    t0 = phase_time(37, t0)
    with heavy("phase 38"):
        gan_cli_phase(card)
    t0 = phase_time(38, t0)

    # flowae: phases 45-48, each asserting K1 = K2 = 0
    dito_rec, dito_ae = dito_phase(card)
    torch.cuda.empty_cache()
    t0 = phase_time(45, t0)
    zdm_rec = zdm_glpto_phase(card, dito_ae)
    torch.cuda.empty_cache()
    t0 = phase_time(46, t0)
    with heavy("phase 47"):
        image_rec = image_phase(card)
    t0 = phase_time(47, t0)
    cli_times = flowae_cli_phase(card, dito_ae)
    del dito_ae
    torch.cuda.empty_cache()
    phase_time(48, t0)

    zeros = {"dac_gan_train": 0, "hift_gan_train": 0,
             "gan_and_extract_cli": 0, **{p: 0 for p in FLOWAE_PATHS}}
    paths.update(zeros)
    k2["launches_by_path"].update(zeros)
    return {"record": {"launches_by_path": paths, "flowae": {
        "dito": dito_rec, "zdm_glpto": zdm_rec, "image": image_rec,
        "cli_s": cli_times}}, "k2": k2}


STREAM_FNS = {"synthesis": stream_synthesis, "lm_train": stream_lm_train,
              "flow_gan": stream_flow_gan}


def stream_worker(argv) -> int:
    """A stream's process, `python chip_smoke.py --stream-worker NAME
    RESULT.json SHARED_JSON`: STREAM_FNS[NAME] on the card, its updates
    to the kernels line written to RESULT.json."""
    import torch

    import signal
    import threading

    name, result, shared = argv
    parent = os.getppid()

    def orphaned():  # the main process ended: end this group with it
        while os.getppid() == parent:
            time.sleep(1)
        os.killpg(0, signal.SIGKILL)
    threading.Thread(target=orphaned, daemon=True).start()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    tf32_off()
    torch.set_num_threads(stream_threads())
    out = STREAM_FNS[name](card_info(), json.loads(shared))
    Path(result).write_text(json.dumps(out))
    return 0


def stop_group(proc) -> None:
    """End a worker and every process it started (its own group)."""
    import signal

    for sig, wait in ((signal.SIGTERM, 30), (signal.SIGKILL, 30)):
        if proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=wait)
        except subprocess.TimeoutExpired:
            pass


def run_streams(card: str, shared: dict) -> list:
    """STREAMS[0] in this process while the others run as workers, each
    in its own process group with its log in build/streams_*/; the
    streams' updates in STREAMS order. Any stream's failure fails the
    run, after every worker has been stopped and its log printed. A
    worker whose parent is gone stops its group (stream_worker)."""
    import signal
    import tempfile

    import torch

    repo = Path(__file__).resolve().parent
    (repo / "build").mkdir(exist_ok=True)
    logs = Path(tempfile.mkdtemp(prefix="streams_", dir=repo / "build"))
    # a SIGTERM to this process stops the workers too (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    threads = stream_threads()
    os.environ["OMP_NUM_THREADS"] = str(threads)  # the CLIs, the ranks
    os.environ[HEAVY_LOCK] = str(logs / "heavy.lock")  # and the workers
    torch.set_num_threads(threads)
    workers, printed = {}, set()

    def show(name):
        if name not in printed:
            printed.add(name)
            log(f"[streams] {name} (beside {', '.join(STREAMS)}):")
            print((logs / f"{name}.log").read_text(), end="", flush=True)

    try:
        for name in STREAMS[1:]:
            with open(logs / f"{name}.log", "w") as out:
                workers[name] = subprocess.Popen(
                    [sys.executable, str(repo / "chip_smoke.py"),
                     STREAM_WORKER, name, str(logs / f"{name}.json"),
                     json.dumps(shared)], cwd=repo, stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True)
        t0 = time.perf_counter()
        log(f"[streams] {STREAMS[0]} here, {', '.join(STREAMS[1:])} in "
            f"workers, {threads} CPU threads each")
        results = [STREAM_FNS[STREAMS[0]](card, shared)]
        log(f"[time] stream {STREAMS[0]}: {time.perf_counter() - t0:.1f} s")
        for name, proc in workers.items():
            rc = proc.wait()
            show(name)
            log(f"[time] stream {name} ended {time.perf_counter() - t0:.1f}"
                f" s after the streams started, rc {rc}")
            if rc:
                tail = (logs / f"{name}.log").read_text()[-6000:]
                print(tail, file=sys.stderr)
                raise AssertionError(f"stream {name} exited {rc}")
            results.append(json.loads((logs / f"{name}.json").read_text()))
        return results
    finally:
        for name, proc in workers.items():
            stop_group(proc)
            show(name)


def merge(rec: dict, update: dict) -> None:
    """rec updated by update, one level into the dicts both hold."""
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(rec.get(k), dict):
            rec[k].update(v)
        else:
            rec[k] = v


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from minimax_speech_torch.infer.pipeline import TTSConfig, TTSPipeline
    from minimax_speech_torch.kernels import build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_info()
    tf32_off()
    log(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]} | "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = phase_time(1, t_start)

    build_phase(build)
    t0 = phase_time(2, t0)

    # phases 3, 4, 6 and 7 alone on the card: the kernels line's times
    train_lm = TTSConfig().lm  # training runs the float LM
    cfg = synthesis_cfg()
    inputs = prompts()
    b, h = 2, cfg.flow.unet.num_heads  # CFG batch of 2
    d = cfg.flow.unet.attention_head_dim
    n_prompt = 75  # 3 s at 25 Hz
    t = 2 * (128 + GEN_TOKENS)  # [prompt bucket | max steps] tokens, 2x
    kv = 2 * (n_prompt + GEN_TOKENS)
    record = k1_checks((b, h, t, d), (kv, kv))
    t0 = phase_time(3, t0)

    pipe = TTSPipeline.from_random(cfg, seed=0, device="cuda")
    pipe.lm.to(torch.bfloat16)
    per_utt, seen = main_path(pipe, inputs, TIMED_RUNS, card, "cuda")
    expect = attn_calls_per_step(cfg.flow.unet) * cfg.flow.n_timesteps
    if any(n != expect for n in per_utt) or seen["bt"] != (b, t) \
            or seen["kv"] != [kv, kv]:
        raise AssertionError(f"K1 on the main path: launches {per_utt} "
                             f"(expected {expect}), shape {seen}")
    del pipe
    torch.cuda.empty_cache()
    t0 = phase_time(4, t0)
    record["launches"] = per_utt[-1]

    batch = lm_batch(train_lm)
    q = train_lm.qwen
    k2 = k2_checks((LM_BATCH, q.n_heads, LM_PAD, q.head_dim),
                   [int(n) for n in batch["seq_len"]])
    t0 = phase_time(6, t0)
    lm_rec = lm_train_phase(train_lm, batch, card)
    k2.update({k: lm_rec[k] for k in ("launches", "launches_per_step",
                                      "step_s", "tokens_per_s")})
    k2["launches_by_path"] = {"lm_train": k2["launches"]}
    del batch
    torch.cuda.empty_cache()
    t0 = phase_time(7, t0)

    extra = []  # phase 51's entries: the kernels at head dims 8 and 16
    for update in run_streams(card, {"lm_off": {
            "step_s": lm_rec["step_s"], "peak_gib": lm_rec["peak_gib"],
            "busy_ms": lm_rec["busy_ms"], "launches": lm_rec["launches"],
            "per_step": lm_rec["launches_per_step"]}}):
        merge(record, update["record"])
        merge(k2, update["k2"])
        extra += update.get("kernels", [])

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record, k2, *extra]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CLI_WORKER]:
        sys.exit(cli_worker(sys.argv[2:]))
    if sys.argv[1:2] == [SYNTH_WORKER]:
        sys.exit(synth_worker(sys.argv[2:]))
    if sys.argv[1:2] == [STREAM_WORKER]:
        sys.exit(stream_worker(sys.argv[2:]))
    sys.exit(main())
