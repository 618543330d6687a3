#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (acestep_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced by a timestamped line:
  1. gpu        the card's name and power limit (nvidia-smi)
  2. build      compile csrc/*.cu, one nvcc per source, all started together,
                into one library in build/kernels/ (ctypes)
  3. check      each kernel against its plain PyTorch version at the shapes the
                10 s and the 60 s paths launch, plus ragged M and N (q8_0 also
                ragged K: 96, 160, 320; the 4-bit kernels the M = 1536 decoder
                shapes of the 120 s bucket).  Every dequant-matmul format: the
                JAX package's kernel-test bound (test_qmm_pallas.py), max error
                below 2% of the mean |output| on the f32 outputs and >= 98% of
                the bf16 outputs equal, each within one bf16 step (2^-7).  VAE
                res unit / trio: 1e-4 in f32 (also N = 2, L = 20 / 45 / 70, below
                the convs' reach), each rerun bit-identical, and the planted
                fault (the kernels built without the lo products: single-pass
                TF32) rejected at the 10 s shapes.  int8-activation q8_0 matmul
                (row 6): bit-identical, and on a rerun, at the LM's shapes (the
                layer linears and the codes head, M 1, 2, 4, 8, 16), the DiT
                timestep shapes (M 1) and layers 1 and 2 of a stacked weight
                read in place; N % 128 != 0 takes the q8_0 kernel
  4. check_dit  the DiT Euler-step megakernel (row 12) at full width (T 128,
                Lc 320), with and without padded condition tokens, through 2
                and 24 random q8_0 layers, at T 256 (two GEMM passes) through
                2 layers, plus a 2-layer case whose sliding
                window (16) masks: each depth held to 1.5x the drift measured
                in this run between its plain version on the card and on the
                CPU (max abs error over the peak, never tighter than 5e-3),
                reruns bit-identical; two planted faults in the plain version
                ("sliding band not applied", "gate_msa dropped"), each rejected
  5. engine     the full-width random q8_0 engine, built on the card
  6. serve      configs[0]: 10 s text2music, 64 style + 256 lyric tokens, one
                seed, through AceStepEngine.generate three times (one warm-up,
                two timed); every kernel of the path launched in each request.
                Then request A: the same at 10.24 s (256 frames fill their
                bucket, no self-attention mask) through a second engine around
                the same weights with dit_mega and int8_act on, three times:
                each launches the megakernel 8 times and row 6 48 times; and
                twice with both switches off, beside it (latent cosine printed)
  7. output     audio_lengths == [480000], int16 [1, >=480000, 2], non-constant,
                finite positive scale; a small engine on the card (kernels)
                against the same engine on the CPU (plain versions): the Q8_0
                gate, cosine >= 0.999 and SNR >= 26 dB, with the ODE sampler
                and with the SDE one (the same per-step draws given to both
                sides); the same for a small engine that meets the
                megakernel's gate, with both switches on
  8. engine60   the full-width random q4_0 engine (the q8_0 engine freed first)
  9. serve60    configs[1]: the same request at 60 s, three times at q4_0
                (q4_0_qmm, q8_0_qmm, vae_res_unit and vae_res_trio launched in
                each), then three times (one warm-up, two timed) at q4_k and at
                q6_k, one full-width engine at a time, each with its own kernel
                launched and the two timed requests' int16 identical
 10. output60   audio_lengths == [2880000], int16 [1, >=2880000, 2],
                non-constant, finite positive scale; a small q4_0, q4_k and q6_k
                engine each on the card against the same engine on the CPU, at
                the Q8_0 gate
 11. check_long banded_attention and flash_attention against dense masked
                attention (ops.nn.attention, in blocks of query rows) at the
                DiT's shapes (16 / 8 heads, D 128, bf16, B 2, item 1's last 300
                keys padded), T 1536 and 7552, valid rows only: the band within
                one bf16 step of the peak (2^-7), flash within two (2^-6: it
                rounds its unnormalised probabilities); a band one wider and a
                flash block that skips its rescale each rejected
 12. long       a full-width q4_k engine serves 120 s (3000 frames, 1536 patch
                tokens: the first blocked length) and 600 s (15000 frames in a
                15104 bucket, 7552 tokens), one warm-up and one timed request
                each: q4_k, q8_0 (proj_in, K = 384), vae_res_unit and
                vae_res_trio launched in each; int16 of exactly frames x 1920 x
                2 samples, finite, not silent; decoded in segments (10 at 600 s,
                vae_overlapped 1), both runs equal; the segments decoded again
                equal the result, and reconciled they equal a one-pass decode
                (pipeline.decode_one_pass) of the same latents (bit for bit in
                a segment decoded at the global scale, one step in one
                re-quantized); time_costs, peak device memory, launches
 13. batch      configs[3]'s mix (10, 10.2, 30, 30.5, 60, 120, 300, 600 s,
                style from default_rng(1), seeds 0-7) through
                ContinuousBatcher(engine.generate, max_batch 8, max_wait 0.3 s,
                pad_ratio 2.5, max_batch_for=engine.max_batch_for_frames), two
                passes: each merge's plan and time_costs, the wall time, merged
                sizes and audio seconds per wall second of each pass; every
                future back with its own length; then a merged 30 s item, the
                same noise given to each run: its latents beside a 60 s partner
                equal bit for bit its latents beside a 55 s one; against the
                same request alone, latents within 40 dB and audio within 3 dB
                of what one decode of the two latents explains (to one overlap
                before its end); the merged decode within the Q8_0 gate of its
                latents decoded alone; two planted merge faults (a wrong valid
                length, swapped condition rows) each rejected
 14. audio_in   phase long's q4_k engine: a 60 s source (a chord of sines plus
                noise 20 dB down, default_rng(2)) and a 40 s reference
                (default_rng(3)), 48 kHz stereo, made with numpy, encoded
                (encode_src_audio [1, 1500, 64], encode_refer_audio
                [1, 1, 750, 64], each timed twice); repaint 20-40 s, cover
                with the reference at strength 0.5 (the switch after 4 steps)
                and at 1.0, lego 10-30 s with a track name, and text2music with
                the reference as timbre only, each at 60 s three times (a
                warm-up, two timed, int16 equal): time_costs, peak device
                memory, launches; (a) the repaint context's src channels are
                the silence latents bit for bit inside the span and the encoded
                source outside it, (b) the cover condition holds lyric + style
                + clips valid tokens and its latents move without the
                reference; each check's planted fault (the span not silenced,
                the timbre token left out) rejected
 15. cfg        a full-width q8_0 engine serves the base model's CFG at 10 s
                (guidance 7, 32 steps, shift 3, the neutral uncond), plain and
                with ADG and the interval [0.1, 0.9], three times each (int16
                of the timed pair equal); q8_0 launches by M (the 2B batch)
 16. output_audio a small engine whose encoder has the full width's 128- and
                256-channel blocks, on the card against the same engine on
                the CPU: encode_src_audio within 1e-4 of the peak, then
                repaint, cover at 0.5 with timbre, lego with a span and CFG at
                the Q8_0 gate on the waveform, CFG with SDE (the same draws
                both sides) and CFG + ADG on the latents (card_vs_cpu_audio
                says why)
 17. checkpoint a small q4_k engine written with the port's save_params to a
                temporary directory, read back through
                serving.launch.build_engine(dir) on the card: the same int16
                output, exactly
 18. convert    the converter on full-width weights: a bf16 DiT (the tree of
                phase train), the bf16 Qwen3-0.6B text encoder and the f32 VAE
                drawn on the card, written in the reference's safetensors
                layout (the importers' transforms inverted; each VAE conv as
                weight_v plus weight_g) to a temporary directory;
                python -m acestep_tpu_torch.convert_checkpoint at q4_k on the
                host (the native C++ quantizers), seconds per component;
                build_engine of its output: the DiT and text-encoder leaves
                equal bit for bit to the drawn trees quantized in memory on
                the card
                (quant.convert.quantize_tree), the VAE's within a few f32 ulps
                (the f64 fold); configs[1]'s 60 s request (explicit noise)
                through rows 4, 1, 7 and 8, its latents equal bit for bit to
                an engine of the in-memory trees and its int16 at the Q8_0
                gate (eval_metrics); a roofline line of its DiT step
 19. recheck    every (kernel, shape) the served requests launched that phase 3
                did not cover, against the plain version: configs[3]'s merged
                batches and the merged-vs-solo runs too
 20. check_lm   the LM decode kernels against their plain versions at the
                0.6B planner's full width (16 query / 8 kv heads, 28 layers of
                int8 cache, T = 1408), B in {1, 4, 8}, lengths 1, 128 and
                ragged, T = 1024 (one T block) and lengths on chunk and T-block
                edges: decode_attn and decode_attn_fused 2e-2 (the fused new
                K/V int8 within 2); decode_mega through its first 2 and all 28
                layers, each depth held to 1.5x the drift measured in this run
                between its plain version on the card and on the CPU (x max
                error / peak, K/V int8 and scales, never tighter than the JAX
                test's 2e-2, 2, 2e-2; the shares of x and of the new K/V that
                differ), argmax equal, reruns and grids of 132 and 199 blocks
                bit-identical with the occupancy grid (20 reruns of the B = 4,
                28-layer case); then four planted faults in the plain version,
                each of which one depth rejects
 21. lm_engine  the full-width random 0.6B q8_0 LM planner (fused weights,
                quantized head, int8 KV), drawn on the card
 22. lm_serve   configs[2]'s LM request through
                LMPipeline.generate_with_stop_condition (byte tokenizer, bpm
                100, 120 s -> exactly 600 codes in [0, 64000), T 0.85, top-p
                0.95): three times on the default path (megakernel), and once
                with thinking (free CoT), cfg 2.0 and batch 4; the same request
                at 30 s (150 codes) once with decode_mega=0 decode_attn=pallas
                and once with fused; then request B, int8_act on, once on the
                default path at 120 s (the head through row 6) and once with
                decode_mega=0 at 30 s (every layer linear too); time_costs and
                launches of every request
 23. recheck_lm the q8_0 matmul shapes the LM requests launched, as phase 19,
                every (B, Hq, Hkv, T) of rows 9-10 and (M, K, N) of row 6 not
                checked yet, and every (B, T) of row 11 not checked in phase
                20, through the LM's own 28 layers at phase 20's 28-layer
                bounds
 24. output_lm  a small LM (1024 wide, 2 layers) greedy on the card against the
                same LM on the CPU (plain versions), both fed the CPU's tokens:
                logits of the first two steps within 2e-2 of the peak (4e-2
                with int8 activations), the top token equal at every step whose
                CPU top-1/top-2 gap is at least 2e-2 of the peak; on the
                megakernel, and with int8_act on the layer scan
 25. check_fsm  the constrained CoT on the small LM of phase 24 over a
                4096-piece demo vocabulary (caption budget 24), user metadata
                {} and {bpm 100, duration 120}: greedy device-DFA tokens
                (serving.lm.generate_with_fsm_device) equal the greedy
                host-FSM tokens on the card, replay valid and done through
                MetadataFSM; the DFA without its caption budget and without
                its exception table (planted faults) each rejected
 26. full       configs[2] whole: a full-width q4_k engine and the 0.6B q8_0 LM
                (int8 KV) through inference.generate_music with
                tools/bench_full_pipeline.py's request (120 s, bpm 100, 64
                style tokens of default_rng(0), 256 lyric tokens of
                default_rng(1)), three times (one warm-up, two timed, int16
                equal): 600 codes in [0, 64000), 120 s of int16 audio, the q8_0
                (rows 1-2), q4_k (row 4), res unit / trio (rows 7, 8) and
                decode megakernel (row 11) kernels launched in each; then the
                +think row: thinking with the constrained CoT over the full
                151,669-piece demo vocabulary, three times and once with
                lm_num_candidates=4 (PMI ranking): the device DFA taken, the
                CoT ids replay valid and done, bpm, keyscale, timesignature,
                language, caption and genres parsed, duration 120 forced;
                then the plain request with a random codec (conv_v1): it
                becomes a cover of the LM codes' hints [1, 3000, 64], and
                understand_audio of the 60 s source (300 codes, 64 tokens)
 27. planners   the larger planners from a checkpoint.  The 1.7B (QWEN3_1_7B)
                drawn on the card in bf16, written in the reference's layout
                with a config.json and the demo vocabulary's tokenizer.json (a
                WordLevel model read by the tokenizers package), converted with
                convert_checkpoint --lm --lm-quant q8_0 on the host and built
                with serving.launch.build_lm (decode_attn fused): its leaves
                equal bit for bit to the drawn tree quantized in memory;
                configs[2]'s song through generate_music with phase full's
                engine (+think on the device DFA, 2 candidates ranked by PMI:
                600 codes, 120 s of int16 audio, finite and not silent); a
                10 s codes phase with int8_act (row 6 at the 1.7B's shapes).
                The 4B (QWEN3_4B) drawn at q8_0, saved with save_params beside
                lm.config.json and the tokenizer, built with build_lm: a 10 s
                codes phase with decode_attn auto (twice), pallas and fused
                (rows 9-10 at 32 / 8 heads), and with int8_act at 16
                candidates (row 6 at M 16 on every linear, the down_proj and
                o_proj shapes that had no plan among them).  Row 11 declines
                both widths (hidden != 1024, as the JAX megakernel does) and
                launches 0 times.  For each planner the first 16 decode steps'
                logits on each kernel path against the plain path on the card,
                both fed the plain run's tokens: within check_mega's 28-layer
                bound (1.5x this run's card-vs-CPU drift; twice that with
                int8_act, as INT8_LOGIT_REL is twice MEGA_REL), the top token
                equal where the gap is at least the bound.  Every launched
                shape of rows 1, 6, 9 and 10 held to its plain version; build
                and conversion seconds, peak memory, prefill ms, decode ms and
                launches a step beside the step's bound, each request's
                time_costs; rows 1 and 6 timed at the 4B's decode shapes, rows
                9-10 at its heads
 28. server     phase full's engine (its DiT tree kept unstacked) saved with
                loader.save_params and read back through
                serving.launch.build_engine; the REST server (ApiServer,
                make_generate_fn, the byte tokenizer, LoRARuntime) on
                127.0.0.1, port 0: (a) 30 s text2music with lyrics, return_lrc,
                FLAC out; (b) 60 s repaint 20-40 s of the audio_in source
                uploaded as WAV; (c) a cover at 0.5 of it with the reference
                uploaded as FLAC; (d) 10 s MP3 out where libmp3lame loads; each
                through /release_task and /query_result, its payload bytes
                equal to those of engine.generate on the request the server
                built (caught on its way in), the upload's latents within 1e-5
                of the peak of an encode of the decoded upload, the LRC, stamps
                and score equal to a direct probe; /v1/lyrics, /health,
                /v1/stats and /studio; a second server with
                make_full_generate_fn and phase full's LM: configs[2]'s song
                equal to generate_music bit for bit; the OpenRouter server:
                one chat completion with a metadata block, its WAV equal to the
                direct request's int16 through read_wav -> write_wav; LoRA: a
                random rank-16 adapter registered, activated, scaled to 0.5
                (the audio moves each time) and deactivated (the base's int16
                bit for bit), the card's merge of two q4_k kernels equal to the
                CPU's; the alignment probe on phase output_audio's small engine
                card vs CPU within 1.5x the drift of its plain version on the
                card, never below 2e-3; wall s via HTTP against the direct
                call, upload decode, FLAC encode, probe and LoRA seconds
 29. train      a full-width bf16 DiT (RandomInit, per-layer unfused lists)
                through training.trainer.Trainer on a numpy batch of 2 (10 s,
                250 frames; 320 condition tokens; item 2's last 50 frames out
                of the loss): 5 LoRA steps (rank 16, alpha 16), 5 LoKr steps
                (factor 8), 3 full steps; every loss finite, the base bit for
                bit after the adapter steps, the decoder's LoRA b leaves zero
                after step 1 (its learning rate is 0) and non-zero after step
                2; ms a step after the first and peak device memory per mode;
                the LoRA state checkpointed and resumed into a fresh Trainer
                bit for bit, then one step from each with the same draws,
                bit-equal
 30. train_check a small bf16 DiT (phase output's width), 3 LoRA and 2 full
                steps on the card and on the CPU with the same draws: losses,
                the gradients and the trained trees within TRAIN_REL; rows 7
                and 8 inside vae_resunit.KernelGrad at the 10 s decode's
                shapes, the forward within 1e-4 of the plain output and the
                gradients w.r.t. x and every weight within 1e-4 of autograd
                through the plain version on the card; a backward without the
                snake's sin^2 term, and the single-pass TF32 kernel as the
                forward, each rejected at each shape
 31. train_server phase full's engine behind the REST server with both
                managers (127.0.0.1, port 0): /v1/dataset/scan and
                /v1/dataset/build over two numpy WAVs (20 s and 30 s, 48 kHz
                stereo, default_rng(4), auto_label off) polled to completed;
                phase train's DiT saved with loader.save_params and a
                config.json; /v1/training/start (lora, 4 steps, lr
                SERVER_TRAIN_LR) polled to completed, its export on disk; the
                same job run directly (the server's overhead); the exported
                adapter registered and activated through /v1/lora (the audio
                moves) and deactivated (the base's int16 bit for bit); build,
                train and activation seconds
 32. cli        python -m acestep_tpu_torch.cli --pipeline-style-lyric
                --audio-seconds 10 in a subprocess on the card: rc 0, the JSON
                line parses, the WAV holds 480000 frames
 33. recheck_full the kernel shapes those requests launched, as phase 23
                (row 11 at the +think CoT's and the candidates' cache
                lengths), and those of the served jobs and the dataset build
 34. timing     kernel, plain-version and library-call times at the served
                shapes, beside the bound (bytes over 3.35 TB/s or operations
                over 989 TFLOP/s bf16 / 1979 TOP/s int8 / 67 TFLOP/s f32; the
                res kernels: three TF32 products over 495 TFLOP/s, the f32
                CUDA-core bound logged beside), the
                dequant-matmul shapes also as a CUDA graph (device time) with
                their TFLOP/s, and the q8_0 kernel at the LM requests' shapes;
                rows 4, 7 and 8 also per 600 s request, rows 7 and 8 per
                60 s source encoded and per dataset sample (their launches in
                the build and in phase train_check's backward check in their
                rows);
                the LM kernels at three valid lengths of the request, weighted
                by its launches (rows 9 / 10 also as CUDA graphs beside SDPA;
                row 11 with its stage split; row 6 at each shape also as CUDA
                graphs beside torch.matmul);
                the DiT megakernel at T 256 and 128 with its stage split, beside
                the layer-path step
 35. tp         serving from a (dp, tp) group of processes (acestep_tpu_torch/
                parallel/): each world's ranks are children of this script
                (``chip_smoke.py --tp-rank SPEC RANK``, outputs in
                build/tp_phase/; a world past TP_CHILD_S, or any rank failing,
                fails the run, and the watchdog kills them), each drawing
                the full-width weights from the earlier phases' seeds on its
                device and keeping its shards; one all_reduce over the world on
                the backend first.  World 1 over NCCL: the 10 s q8_0 request,
                latents and int16 equal to phase serve's bit for bit.  Worlds
                2 and 4 over gloo, every rank on cuda:0 (NCCL takes one rank a
                card): the 10 s request at (dp, tp) = (1, 2) and (1, 4), phase
                serve's batch of two at (2, 2) (split over dp), the 60 s q4_k
                request at (1, 2) (its decode windows dealt over both ranks),
                and phase lm_engine's 0.6B planner, TP_LM_STEPS greedy codes at
                tp 2 and 4 on rows 9 and 10: every rank's outputs equal bit for
                bit; latents against the one process at the Q8_0 gate, the
                waveform against the one process's decode of those latents at
                the gate, and against the one-process waveform no more than
                TP_WITNESS_MARGIN_DB below a witness (the one process's
                latents plus white noise of the world's latent difference's
                power, decoded: the random decoder magnifies any latent
                difference); the planner's
                tokens equal until a step whose top-1 / top-2 gap is below
                check_mega's drift; each rank's seconds and peak memory, the
                kernels launched at every new shape held to their plain
                versions as in phase check (rows 1, 4, 7-8, 9-10).  Beside the
                serving: the lyric alignment probe of the 10 s request's
                latents at tp 1, 2 and 4 (against the one process's probe of
                the same latents: bit for bit at tp 1, else the map within
                TP_MAP_ATOL and the score within TP_SCORE_RTOL, the CPU tests'
                bounds); rank 0's continuous batcher at (2, 2) (the batch of
                two's items as two requests, merged on rank 0 and broadcast as a
                fixed-size payload, served by every rank: equal to the world's
                meshed batch of two bit for bit); two full fine-tune steps
                (make_tp_train_step) of the full-width DiT cut to
                TP_TRAIN_LAYERS layers in f32 at (1, 1), (1, 2) and (2, 2),
                against the one process's make_train_step on the same draws:
                bit for bit over NCCL at world 1, else the update within
                TP_UPDATE_TOL and the losses within TP_LOSS_RTOL.  With two or
                more cards, NCCL over them too (a card a rank)
 36. quality    the quantization-quality tools (outputs in build/quality/):
                (a) eval_quant_pipeline at full width, 10 s, bf16 and the four
                formats from one bf16 tree drawn on the card, its rows beside
                the nvidia-smi line, each variant's launches (a warm-up and a
                timed request), every shape held to its plain version as in
                phase check; (b) train_quality_eval on a reduced schedule at
                half scale (QUALITY_VAE_STEPS VAE steps at batch
                QUALITY_VAE_BATCH over QUALITY_SONGS songs, the dataset,
                QUALITY_DIT_STEPS DiT steps, the eval and its decoder-leg
                control), rows 7-8 inside KernelGrad in the VAE steps, their
                backward held to the plain version's autograd at the half-scale
                encoder's shapes as phase train_check does; (c) the half-scale
                VAE's loss and gradients on the card against the CPU within
                VAE_DRIFT_FACTOR x the drift of the plain path on the card (res
                units as plain convs), never tighter than the floors, then
                QUALITY_CMP_STEPS steps on each path, their divergence logged; (d)
                ablate_quant_noise's parts A-C on the card (row 1 against
                torch.matmul in f32), the format-level cosine above 0.999
Then one {"kernels": [...]} line (each row also with its launches in phase
planners, "launches_planners", in phase tp, "launches_tp", and in phase
quality, "launches_quality"), the nvidia-smi
line, and last the result line.
A watchdog ends the run with a non-zero code, naming the phase that overran.
Without a card, or outside the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 1100          # whole run, the kernels' build included (limit 1200 s)
QMM_REL_MAX, QMM_EQUAL_MIN = 0.02, 0.98
RES_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
FOUR_BIT = ("q4_0", "q4_k", "q6_k")
# LM planner (configs[2]'s codes phase, tools/bench_full_pipeline.py:151-152)
LM_CAPTION = "epic orchestral with soaring strings"
LM_LYRICS = "[verse]\nacross the silver sea\n[chorus]\nrise again\n"
LM_DURATION_S = 120.0
LM_CODES = 600                 # 120 s at 5 codes/s (code bucket 768)
# phase lm_serve's three layer-scan requests (decode_mega=0: decode_attn pallas
# and fused, request B's layer scan) at 30 s: 150 codes (code bucket 256), a
# third of the steps, so that the script keeps to its time with phase planners
LM_SCAN_S = 30.0
LM_T = 1408                    # cache length of that request (round_len(512 + 768 + 1))
FSM_CAPTION = 24               # check_fsm's caption budget: it binds, so a dropped budget shows
ATTN_TOL = 2e-2                # test_decode_attn_pallas.py:52
MEGA_REL = 2e-2                # test_decode_mega.py:64-70: logits / rows
# int8 activations amplify the surrounding ops' rounding differences: one bf16
# step of an activation can move its int8 value a whole step of amax / 127
# (tests/test_torch_qmm_int8.py); the LM logits with int8_act are held to twice
# the JAX decode bound
INT8_LOGIT_REL = 4e-2
INT8_MAX_DIFF = 2              # test_decode_mega.py:70: cache int8
SCALE_RTOL = 2e-2              # test_decode_mega.py: new K/V scales
# The megakernel: two correct orders of the same f32 sums part by a bf16 step
# of the residual now and then, and that grows with depth.  check_lm measures
# that drift in every run (the plain version on the card against itself on the
# CPU, on the same inputs) at 2 and at 28 layers, and holds the kernel at each
# depth to DRIFT_FACTOR times it: errors never tighter than the JAX bounds, and
# the shares of x and of the new K/V that differ from the plain version
DRIFT_FACTOR = 1.5
# the plain version with one rule of the megakernel's numerics broken
# (decode_mega.py:208-354), run beside it to show what each bound can see
MEGA_FAULTS = ("qkv rounded to bf16", "probabilities against the chunk max",
               "residual kept in f32", "self term dropped")
INT8_OPS = 1979e12
# request A: the DiT megakernel's path (frames fill the 256-frame bucket)
DIT_A_S = 10.24
DIT_T, DIT_LC = 128, 320       # patch tokens; packed condition (64 + 256 token buckets)
DIT_T2 = 256                   # 20.48 s: the longest full-width T row 12 is timed at
DIT_REL_MIN = 5e-3             # test_dit_mega.py:93 (atol 5e-3 at outputs of order 1)
DIT_FAULTS = ("sliding band not applied", "gate_msa dropped")
# long songs (ROADMAP item 4) and configs[3] (tools/bench_configs.py:95-105)
LONG_S = (120.0, 600.0)        # 3000 frames (1536 patch tokens) and 15000 (7552)
LONG_T = (1536, 7552)          # the self-attention lengths of those buckets
LONG_PAD = 300                 # padded keys of item 1 in check_long
CONFIGS3_S = (10.0, 10.2, 30.0, 30.5, 60.0, 120.0, 300.0, 600.0)
# blocked vs dense attention, max err / peak over valid rows.  CPU parity runs
# (tests/test_torch_blocked_attention.py; and the port's own on the CPU at
# T 1536 with these shapes) give 5.8e-4 for the band, the same function summed
# in another order, and 5.6e-3 for flash, which rounds the unnormalised
# probabilities to bf16 where dense attention rounds the normalised ones:
# bounds of one bf16 step of the peak (2^-7) and of two (2^-6)
BANDED_REL = 2.0 ** -7
FLASH_REL = 2.0 ** -6
# a merged item against the same request alone (merged_vs_solo).  On the CPU
# its latents are equal bit for bit (tests/test_torch_batcher.py).  On the
# H100 the kernels sum in an order that depends on M: the latents part by
# 52.33 dB, and by -0.04 dB with the condition rows swapped; the bound lies
# between.  A wrong valid length parts them by 51.44 dB: only the isolation
# check, which is exact, sees it.  The random full-width decode magnifies the
# latents' difference 29.69 dB, to 22.64 dB, as far as the two requests' audio
# parts: that is held within 3 dB of what the decode explains
MERGE_LAT_DB = 40.0
MERGE_AUDIO_SLACK_DB = 3.0
# the audio-in tasks (phase audio_in): a 60 s source and a 40 s reference,
# made with numpy, at 48 kHz stereo
AUDIO_SR = 48000
SRC_S, REFER_S = 60.0, 40.0
SRC_CHORD = (220.0, 277.18, 329.63)        # A major
REFER_CHORD = (196.0, 246.94, 293.66)      # G major
REPAINT_SPAN = (20.0, 40.0)
LEGO_SPAN = (10.0, 30.0)
COVER_STRENGTH = 0.5
# the base model's CFG (phase cfg): 10 s, 32 steps, guidance 7, shift 3
CFG_SCALE, CFG_STEPS = 7.0, 32
UNDERSTAND_TOKENS = 64         # understand_audio's token budget in phase full
# the servers (phase server): request (a) 30 s, (b) and (c) 60 s; a rank-16 LoRA
SERVER_A_S, SERVER_B_S = 30.0, 60.0
LORA_RANK = 16
PROBE_ATOL = 2e-3              # tests/test_torch_alignment.py: the probe against the JAX package
POLL_S = 0.05                  # a client's /query_result period (and 0.002 once, to show contention)
TRAIN_T, TRAIN_LC, TRAIN_MASKED = 250, 320, 50    # 10 s, the condition tokens, frames out of item 2's loss
TRAIN_STEPS = (("lora", 5), ("lokr", 5), ("full", 3))
TRAIN_LR = 1e-4
# phase train_check's card-vs-CPU bound on a small bf16 DiT (norm of the difference
# over the CPU's, per leaf): the products are f32 on both sides, so the steps
# differ where a bf16 rounding of an activation lands on the other side of a tie
TRAIN_REL = 2e-2
# the REST job's learning rate: 4 steps (the first at 0, then the cosine) move the
# rank-16 b leaves by ~1e-2, the merged deltas by ~2e-3 against the q4_k steps
# of ~5e-3 of these weights, so many requantized fields change
SERVER_TRAIN_LR = 5e-3
CLI_TIMEOUT_S = 300
# phase quality: (b) train_quality_eval's reduced schedule, (c) the VAE's loss
# and gradients card vs CPU: the kernel path within VAE_DRIFT_FACTOR x the plain
# path's drift on the card, never tighter than the floors (the loss relative;
# each leaf's gradient, norm relative: the res kernels' bound, and ten times it
# after the encoder's and decoder's layers)
QUALITY_VAE_STEPS, QUALITY_VAE_BATCH, QUALITY_SONGS = 20, 16, 8
QUALITY_DIT_STEPS, QUALITY_DIT_BATCH = 20, 8
QUALITY_CMP_STEPS, QUALITY_CMP_BATCH = 4, 4
VAE_DRIFT_FACTOR, VAE_LOSS_FLOOR, VAE_GRAD_FLOOR = 2.0, RES_TOL, 10 * RES_TOL

T0 = time.perf_counter()
_state = {"phase": "start"}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')} +{time.perf_counter() - T0:7.1f}s] {msg}",
          flush=True)


def phase(name: str) -> None:
    _state["phase"] = name
    log(f"== phase {name}")


def _watchdog() -> None:
    deadline = T0 + WATCHDOG_S
    while time.perf_counter() < deadline:
        time.sleep(1.0)
    print(f"[chip_smoke] watchdog: phase '{_state['phase']}' overran {WATCHDOG_S} s",
          flush=True)
    for p in _state.get("children", []):
        p.kill()
    os._exit(3)


class Failure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    the graph replayed ``replays`` times between two CUDA events (no host
    cost between the launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    err = max_err(got, ref)
    ok = bool(torch.all((got.float() - ref.float()).abs()
                        <= atol + rtol * ref.float().abs()))
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite kernel output")
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


class QmmCase:
    """A random weight [K, N] quantized to ``fmt`` (f32 scales, as the engine
    keeps them) and activations [M, K] on the card."""

    def __init__(self, fmt, m, k, n, seed):
        import torch
        from acestep_tpu_torch.ops.qlinear import precast_quant_scales
        from acestep_tpu_torch.quant import dequantize, quantize

        g = torch.Generator(device="cuda").manual_seed(seed)
        stored = quantize(torch.randn((k, n), generator=g, device="cuda") * 0.02, fmt)
        # the bound counts the weight as the format stores it (f16 scales); the
        # kernels' f32 scale stream is overhead the bound does not grant them
        self.weight_bytes = stored.nbytes
        self.qt = precast_quant_scales(stored)
        self.x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        self.wd = dequantize(self.qt, torch.bfloat16)
        self.m, self.k, self.n = m, k, n

    def bound(self):
        m, k, n = self.m, self.k, self.n
        return bound_ms(m * k * 2 + self.weight_bytes + m * n * 2, 2.0 * m * k * n, BF16_FLOPS)


def _unit_params(c, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s=0.3):
        return torch.randn(shape, generator=g, device="cuda") * s

    return {"snake1": {"alpha": r(c), "beta": r(c)},
            "conv1": {"w": r(7, c, c, s=1.0 / math.sqrt(7 * c)), "b": r(c, s=0.05)},
            "snake2": {"alpha": r(c), "beta": r(c)},
            "conv2": {"w": r(1, c, c, s=1.0 / math.sqrt(c)), "b": r(c, s=0.05)}}


def _res_x(n, length, c, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, length, c), generator=g, device="cuda") * 0.5


def res_bound(n, length, c, units):
    """The res kernels' bound as they compute: three TF32 products a
    multiply-add (3xTF32) over 495 TFLOP/s; and the f32 CUDA-core bound (67
    TFLOP/s), logged beside it."""
    nbytes = 2 * n * length * c * 4 + units * (8 * c * c + 6 * c) * 4
    flops = units * 2.0 * n * length * c * c * 8
    return bound_ms(nbytes, 3 * flops, TF32_FLOPS), bound_ms(nbytes, flops, F32_FLOPS)[0]


def check_qmm(fmt, shape, seed) -> float:
    """The format's kernel against its plain version on one shape; returns the
    max abs error of the bf16 outputs."""
    import torch
    from acestep_tpu_torch.ops.cuda import qmm

    case = QmmCase(fmt, *shape, seed)
    name = f"{qmm.KERNELS[fmt].name} M={shape[0]} K={shape[1]} N={shape[2]}"
    got = qmm._launch(case.x, case.qt, None, torch.bfloat16)
    ref = qmm.qmm_plain(case.x, case.qt)
    got32 = qmm._launch(case.x, case.qt, None, torch.float32)
    ref32 = qmm.qmm_plain(case.x, case.qt, None, torch.float32)
    require(bool(torch.isfinite(got32).all() and torch.isfinite(got.float()).all()),
            f"{name}: non-finite kernel output")
    rel = float((got32 - ref32).abs().max() / ref32.abs().mean())
    g, r = got.float(), ref.float()
    equal = float((g == r).float().mean())
    one_step = bool(((g - r).abs() <= 2.0 ** -7 * r.abs() + 1e-4 * r.abs().mean()).all())
    ok = rel < QMM_REL_MAX and equal > QMM_EQUAL_MIN and one_step
    err = max_err(got, ref)
    log(f"  {name}: f32 max err / mean|ref| {rel:.2e} (< {QMM_REL_MAX}), bf16 equal "
        f"{equal:.5f} (> {QMM_EQUAL_MIN}), within one bf16 step {one_step}, "
        f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return err


def check_unit(shape, seed) -> float:
    """The unit kernel against its plain version, and a rerun bit-identical."""
    import torch
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n, length, c, d = shape
    x = _res_x(n, length, c, seed)
    ops = vru.unit_operands(_unit_params(c, seed), x.device)
    got = vru.launch_unit(x, ops, d)
    name = f"vae_res_unit N={n} L={length} C={c} d={d}"
    require(torch.equal(got, vru.launch_unit(x, ops, d)), f"{name}: rerun not bit-identical")
    return check_close(name, got, vru.res_unit_plain(x, *ops.plain, d), RES_TOL, RES_TOL)


def check_trio(shape, seed) -> float:
    """The trio kernel against its plain version, and a rerun bit-identical."""
    import torch
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n, length, c = shape
    x = _res_x(n, length, c, seed)
    ops = vru.trio_operands(tuple(_unit_params(c, seed + i) for i in range(3)), x.device)
    got = vru.launch_trio(x, ops)
    name = f"vae_res_trio N={n} L={length} C={c}"
    require(torch.equal(got, vru.launch_trio(x, ops)), f"{name}: rerun not bit-identical")
    return check_close(name, got, vru.res_trio_plain(x, *ops.plain), RES_TOL, RES_TOL)


def res_fault_rejected(kind, shape, seed) -> None:
    """The planted fault: the kernel built without the lo products (single-pass
    TF32) must miss the 1e-4 bound that the kernel meets."""
    import torch
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    n, length, c = shape[:3]
    x = _res_x(n, length, c, seed)
    if kind == "unit":
        d = shape[3]
        ops = vru.unit_operands(_unit_params(c, seed), x.device)
        got, ref = vru.launch_unit_tf32(x, ops, d), vru.res_unit_plain(x, *ops.plain, d)
    else:
        ops = vru.trio_operands(tuple(_unit_params(c, seed + i) for i in range(3)), x.device)
        got, ref = vru.launch_trio_tf32(x, ops), vru.res_trio_plain(x, *ops.plain)
    outside = float(((got - ref).abs() / (RES_TOL + RES_TOL * ref.abs())).max())
    log(f"  planted fault: vae_res_{kind} {shape} single-pass TF32: max err / bound "
        f"{outside:.2f}, max_abs_err {max_err(got, ref):.3e} "
        f"{'rejected' if outside > 1 else 'NOT rejected'}")
    require(outside > 1, f"vae_res_{kind} {shape}: the 1e-4 check let single-pass TF32 pass")


def main_path_shapes(dit_cfg, text_cfg, n_style=64, n_lyric=256, frames=256):
    """The quantized matmul shapes (M, K, N) a batch-1 request with ``frames``
    bucketed latent frames launches (from the configs; 256 frames = 10 s,
    1536 = 60 s)."""
    h, hd = dit_cfg.hidden_size, dit_cfg.head_dim
    nh, nkv, inter = dit_cfg.num_attention_heads, dit_cfg.num_key_value_heads, \
        dit_cfg.intermediate_size
    th = text_cfg.hidden_size
    tp = frames // dit_cfg.patch_size
    lc = n_style + n_lyric
    qmm = {
        # text encoder (M = style tokens)
        (n_style, th, text_cfg.num_attention_heads * text_cfg.head_dim),
        (n_style, th, text_cfg.num_key_value_heads * text_cfg.head_dim),
        (n_style, text_cfg.num_attention_heads * text_cfg.head_dim, th),
        (n_style, th, text_cfg.intermediate_size),
        (n_style, text_cfg.intermediate_size, th),
        (n_style, dit_cfg.text_hidden_dim, h),                  # text_projector
        # lyric encoder (M = lyric tokens)
        (n_lyric, dit_cfg.text_hidden_dim, h), (n_lyric, h, nh * hd), (n_lyric, h, nkv * hd),
        (n_lyric, nh * hd, h), (n_lyric, h, inter), (n_lyric, inter, h),
        # condition projection and cross K/V (M = packed condition)
        (lc, h, h), (lc, h, nkv * hd),
        # timestep embeddings (M = batch)
        (1, 256, h), (1, h, h), (1, h, 6 * h),
        # decoder (M = patches): proj_in, fused qkv, o, cross q/o, fused gate-up, down, proj_out
        (tp, dit_cfg.in_channels * dit_cfg.patch_size, h), (tp, h, (nh + 2 * nkv) * hd),
        (tp, nh * hd, h), (tp, h, 2 * inter), (tp, inter, h),
        (tp, h, dit_cfg.audio_acoustic_hidden_dim * dit_cfg.patch_size),
    }
    return sorted(qmm)


def shapes_by_kernel(fmt, shapes):
    """{kernel format: shapes} of an engine quantized to ``fmt`` (a 4-bit
    format keeps q8_0 where K % 256 != 0)."""
    from acestep_tpu_torch.quant import supported_format_for

    out = {}
    for shape in shapes:
        out.setdefault(supported_format_for(shape[1], fmt), []).append(shape)
    return out


def counted_kernels():
    """Every kernel's launch counter (``_build.Counted``)."""
    from acestep_tpu_torch.ops.cuda import decode_attn, decode_mega, dit_mega, qmm, qmm_int8
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    return [*qmm.KERNELS.values(), qmm_int8.INT8, vru.UNIT, vru.TRIO, decode_attn.ATTN,
            decode_attn.FUSED, decode_mega.MEGA, dit_mega.MEGA]


def reset_counts() -> None:
    for k in counted_kernels():
        k.reset()


def snapshot_counts():
    """(launches by kernel name, shapes by kernel name) since the last reset."""
    kernels = counted_kernels()
    return {k.name: k.launches for k in kernels}, {k.name: dict(k.shapes) for k in kernels}


def serve(engine, req, label, n_requests, need, exact=None):
    """``n_requests`` of ``req`` (the first a warm-up), the counts reset just
    before each and read just after; every kernel named in ``need`` must launch
    in each, each named in ``exact`` exactly that many times.  Returns the
    results and the last request's (launches, shapes)."""
    results, counts = [], None
    for i in range(n_requests):
        reset_counts()
        res = engine.generate(req)
        counts = snapshot_counts()
        results.append(res)
        kind = "warm-up" if i == 0 else "timed"
        log(f"{label} request {i} ({kind}): time_costs "
            + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
        log(f"{label} request {i} launches: "
            + json.dumps({k: v for k, v in counts[0].items() if v}))
        require(all(counts[0][name] > 0 for name in need),
                f"{label} request {i}: a kernel of the path was not launched "
                f"(need {need})")
        for name, n in (exact or {}).items():
            require(counts[0][name] == n, f"{label} request {i}: {name} launched "
                    f"{counts[0][name]} times, {n} expected")
    return results, counts


def check_audio(results, length):
    import numpy as np

    for res in results:
        a = res.audio_i16
        require(res.audio_lengths == [length], f"audio_lengths {res.audio_lengths}")
        require(a.dtype == np.int16 and a.ndim == 3 and a.shape[0] == 1
                and a.shape[1] >= length and a.shape[2] == 2, f"audio_i16 shape {a.shape}")
        require(int(a.max()) != int(a.min()), "constant audio")
        require(math.isfinite(res.audio_scale) and res.audio_scale > 0,
                f"audio_scale {res.audio_scale}")
        require(bool(np.isfinite(res.latents).all()), "non-finite latents")
    log(f"audio {results[-1].audio_i16.shape} int16, scale {results[-1].audio_scale:.6g}, "
        f"std {results[-1].audio_i16.std():.1f}")


def free_engine() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the audio-in tasks
# ---------------------------------------------------------------------------

def chord_waveform(seconds: float, seed: int, freqs):
    """A stereo 48 kHz chord of sines (random phases, the right channel 5 ms
    behind) plus white noise 20 dB below the chord's power, f32 [L, 2]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * AUDIO_SR)) / AUDIO_SR
    chord = sum(np.sin(2 * np.pi * f * t + ph)
                for f, ph in zip(freqs, rng.uniform(0, 2 * np.pi, len(freqs))))
    chord = 0.15 * np.stack([chord, np.roll(chord, AUDIO_SR // 200)], axis=1)
    noise = rng.standard_normal(chord.shape) * np.sqrt(np.mean(chord ** 2) / 100.0)
    return (chord + noise).astype(np.float32)


def span_context_ok(ctx, src, sil, lo: int, hi: int) -> bool:
    """Check (a), from the encoded source and the silence latents alone: in
    frames [lo, hi) the context's src channels are the silence latents bit for
    bit and its mask 1; elsewhere the source (zero past its end) and mask 0."""
    import numpy as np

    d = src.shape[-1]
    want = np.zeros(ctx[..., :d].shape, np.float32)
    want[:, :src.shape[1]] = src
    want[:, lo:hi] = sil[:, lo:hi]
    mask = np.zeros(ctx.shape[1], np.float32)
    mask[lo:hi] = 1.0
    return bool(np.array_equal(ctx[..., :d], want) and (ctx[..., d:] == mask[None, :, None]).all())


def serve_peak(engine, req, label, need, length):
    """``serve`` of three requests (a warm-up and two timed) with the peak
    device memory over them; the timed pair's int16 equal."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, counts = serve(engine, req, label, 3, need)
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(np.array_equal(results[1].audio_i16, results[2].audio_i16),
            f"two runs of {label} differ")
    check_audio(results, length)
    return results, counts


def serve_audio_in(engine, style, lyric, src_wave, refer_wave, path, vae_cfg):
    """Phase audio_in on a full-width engine: the 60 s source and the 40 s
    reference encoded, then repaint, cover at 0.5 and 1.0, lego with a span
    and text2music with the reference as timbre, each three times at 60 s;
    the span and timbre checks with their planted faults.  Returns (source
    latents, {key: (launches, shapes)})."""
    import numpy as np
    import torch

    from acestep_tpu_torch import pipeline

    served = {}
    for key, label, fn, want in (
            ("encode 60s", f"encode_src_audio ({SRC_S:g} s)",
             lambda: engine.encode_src_audio(src_wave), (1, 1500, 64)),
            ("encode refer", f"encode_refer_audio ({REFER_S:g} s, cut to 30 s)",
             lambda: engine.encode_refer_audio([refer_wave]), (1, 1, 750, 64))):
        secs = []
        for _ in range(2):
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()                   # numpy: the device work is done
            secs.append(time.perf_counter() - t)
            served[key] = snapshot_counts()
        require(out.shape == want and np.isfinite(out).all(), f"{label}: {out.shape}")
        log(f"{label}: {out.shape}, s (first, second) {secs[0]:.4f}, {secs[1]:.4f}; launches "
            + json.dumps({k: v for k, v in served[key][0].items() if v}))
        if key == "encode 60s":
            src = out
        else:
            refer = out
    frames = pipeline.frames_for_duration(SRC_S)
    base = pipeline.GenerationRequest(duration_s=SRC_S, style_token_ids=style,
                                      lyric_token_ids=lyric, seeds=[1], src_latents=src)
    reqs = {
        "repaint": dict(task="repaint", repaint_start_s=REPAINT_SPAN[0],
                        repaint_end_s=REPAINT_SPAN[1]),
        "cover 0.5": dict(task="cover", refer_latents=refer,
                          audio_cover_strength=COVER_STRENGTH),
        "cover 1.0": dict(task="cover", refer_latents=refer, audio_cover_strength=1.0),
        "lego": dict(task="lego", repaint_start_s=LEGO_SPAN[0], repaint_end_s=LEGO_SPAN[1],
                     track_name="guitar"),
        "timbre": dict(task="text2music", src_latents=None, refer_latents=refer),
    }
    results = {}
    for key, kw in reqs.items():
        label = f"{SRC_S:g} s {key}"
        results[key], served[label] = serve_peak(engine, dataclasses.replace(base, **kw), label,
                                                 path, frames * vae_cfg.hop_length)
    # (a) the repaint span, from the source and the silence latents alone
    t = pipeline.bucket_frames(frames)
    rep = dataclasses.replace(base, **reqs["repaint"])
    ctx = engine.build_context_latents(rep, 1, t, frames).cpu().numpy()
    sil = engine._silence_frames(t).cpu().numpy()
    lo, hi = (int(s * 25) for s in REPAINT_SPAN)
    ok = span_context_ok(ctx, src, sil, lo, hi)
    faulty = ctx.copy()
    faulty[:, lo:hi, :src.shape[-1]] = src[:, lo:hi]        # planted: the span not silenced
    caught = not span_context_ok(faulty, src, sil, lo, hi)
    log(f"repaint context: frames [{lo}, {hi}) silence bit for bit and mask 1, the source "
        f"elsewhere: {ok}; planted fault (span not silenced) {'rejected' if caught else 'NOT rejected'}")
    require(ok and caught, "the repaint span check failed or missed its planted fault")
    # (b) the cover condition holds the timbre token
    cov = dataclasses.replace(base, **reqs["cover 0.5"])
    want = lyric.shape[1] + style.shape[1] + refer.shape[1]
    n_valid = int(engine.build_condition(cov, 1)[1].sum())
    n_fault = int(engine.build_condition(dataclasses.replace(cov, refer_latents=None), 1)[1].sum())
    no_ref = engine.generate(dataclasses.replace(cov, refer_latents=None))
    moved = float(np.abs(no_ref.latents - results["cover 0.5"][-1].latents).max())
    log(f"cover condition: {n_valid} valid tokens ({want} = lyric + style + clips); planted fault "
        f"(timbre token left out): {n_fault}, {'rejected' if n_fault != want else 'NOT rejected'}; "
        f"latents without the reference part by up to {moved:.4f}")
    require(n_valid == want and n_fault != want and moved > 1e-3,
            "the cover condition check failed or missed its planted fault")
    return src, served


def scaled_kernels(tree, s: float):
    """Every 2-D linear kernel times ``s`` (a q8_0 weight through its f32
    scales: exact for a power of two), as the CPU parity tests scale their
    tiny models (tests/test_torch_models.py::_scale_kernels)."""
    from acestep_tpu_torch.quant import QuantTensor

    if isinstance(tree, list):
        return [scaled_kernels(v, s) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "kernel" and isinstance(v, QuantTensor):
            v = QuantTensor(v.fmt, v.shape, **{f: a * s if f == "scales" else a
                                               for f, a in v.fields().items()})
        elif k == "kernel":
            v = v * s
        out[k] = scaled_kernels(v, s)
    return out


def audio_small_cfgs(small_dit):
    """(DiT, VAE) configs of phase output_audio's small engine: the encoder
    with the full width's first blocks (128 and 256 channels) and 64 latent
    channels."""
    from acestep_tpu_torch.config import VAEConfig

    vae_cfg = VAEConfig(encoder_hidden_size=128, decoder_channels=128, decoder_input_channels=64,
                        downsampling_ratios=(2, 2, 2), channel_multiples=(1, 2, 4))
    dit_cfg = dataclasses.replace(small_dit, in_channels=192, audio_acoustic_hidden_dim=64,
                                  timbre_hidden_dim=64, num_timbre_encoder_hidden_layers=1)
    return dit_cfg, vae_cfg


def card_vs_cpu_audio(src_wave, refer_wave, small_dit, small_text, need):
    """Phase output_audio: a small engine whose encoder has the full width's
    first blocks (128 and 256 channels, so rows 7-8 encode) on the card
    against the same engine on the CPU (plain versions): the encode of the
    same waveform within rows 7-8's 1e-4 f32 bound, then at 10 s on the CPU's
    source and reference latents, the same noise and draws on both sides:
    repaint, cover at 0.5 with timbre, lego with a span and CFG (the neutral
    uncond) at the Q8_0 gate on the waveform; CFG with SDE and CFG with ADG
    (a 5-token uncond) at the gate on the latents.

    Measured on the H100 (PERF.md, PR 16): the random small decoder magnifies
    a latent difference the more the larger the latents are (turbo latents
    scaled x4 go from 47 dB to 25 dB of waveform).  CFG with SDE agrees to
    45.7 dB in its latents and 26.7 dB (cosine 0.99893) in its waveform.  ADG
    runs with the DiT's kernels scaled x2: at init scale the condition moves
    this random model's velocity by 5% (|v_c - v_u| / |v_c| 0.054), a delta
    that ADG renormalises to |v_c|, so the bf16 rounding of both velocities
    grows ~19-fold (latents 24-28 dB); scaled x2 the latents agree to 36 dB,
    and guided latents 3x the turbo ones leave 19 dB of waveform."""
    import numpy as np
    import torch

    from acestep_tpu_torch import pipeline, weights

    dit_cfg, vae_cfg = audio_small_cfgs(small_dit)
    cpu = pipeline.build_random_engine(device="cpu", quant="q8_0", seed=3, dit_cfg=dit_cfg,
                                       vae_cfg=vae_cfg, text_cfg=small_text)
    gpu = pipeline.AceStepEngine(
        weights.tree_to(cpu.dit_params, "cuda"), dit_cfg, weights.tree_to(cpu.vae_params, "cuda"),
        vae_cfg, weights.tree_to(cpu.text_params, "cuda"), small_text, device="cuda")
    hop = vae_cfg.hop_length
    wave = src_wave[:250 * hop]          # 250 frames: 10 s of latents at this VAE's hop
    src = cpu.encode_src_audio(wave)
    before = snapshot_counts()[0]
    got = gpu.encode_src_audio(wave)
    after = snapshot_counts()[0]
    err = float(np.abs(got - src).max() / np.abs(src).max())
    log(f"small encoder (128 / 256 channels), card vs CPU: encode_src_audio {got.shape}, max "
        f"err / peak {err:.2e} (<= {RES_TOL:g})")
    require(got.shape == src.shape == (1, 250, 64) and err <= RES_TOL
            and all(after[n] > before[n] for n in need[1:]),
            "the small encoder's card output disagrees with the CPU's, or missed rows 7-8")
    refer = cpu.encode_refer_audio([refer_wave[:100 * hop]])
    rng = np.random.default_rng(1)
    req = pipeline.GenerationRequest(
        duration_s=10.0, style_token_ids=rng.integers(0, 512, (1, 20)),
        lyric_token_ids=rng.integers(0, 512, (1, 40)), seeds=[2], src_latents=src)
    uncond = rng.integers(0, 512, (1, 5))
    noise = torch.randn((1, 256, 64), generator=torch.Generator().manual_seed(5))
    scaled = pipeline.AceStepEngine(scaled_kernels(cpu.dit_params, 2.0), dit_cfg,
                                    cpu.vae_params, vae_cfg, cpu.text_params, small_text,
                                    device="cpu")
    pairs = {1.0: (cpu, gpu), 2.0: (scaled, pipeline.AceStepEngine(
        weights.tree_to(scaled.dit_params, "cuda"), dit_cfg, gpu.vae_params, vae_cfg,
        gpu.text_params, small_text, device="cuda"))}
    cfg = dict(src_latents=None, guidance_scale=5.0, infer_steps=8)
    # (name, request fields, kernel scale, what the gate holds)
    cases = (("repaint", dict(task="repaint", repaint_start_s=2.0, repaint_end_s=6.0), 1.0,
              "audio"),
             ("cover 0.5 with timbre", dict(task="cover", refer_latents=refer,
                                            audio_cover_strength=COVER_STRENGTH), 1.0, "audio"),
             ("lego with span", dict(task="lego", repaint_start_s=3.0, repaint_end_s=7.0,
                                     track_name="bass"), 1.0, "audio"),
             ("CFG (ODE)", cfg, 1.0, "audio"),
             ("CFG (SDE)", dict(cfg, infer_method="sde", uncond_style_token_ids=uncond), 1.0,
              "latents"),
             ("CFG + ADG (ODE)", dict(cfg, use_adg=True, uncond_style_token_ids=uncond), 2.0,
              "latents"))
    for name, kw, scale, held in cases:
        r = dataclasses.replace(req, **kw)
        on_cpu, on_gpu = pairs[scale]
        draws = {}
        if r.infer_method == "sde":
            draws["sde_noise"] = torch.randn((8, 1, 256, 64),
                                             generator=torch.Generator().manual_seed(6))
        before = snapshot_counts()[0]
        ref = on_cpu.generate(r, noise=noise, **draws)
        out = on_gpu.generate(r, noise=noise, **draws)
        after = snapshot_counts()[0]
        require(all(after[n] > before[n] for n in need),
                f"small engine {name} on the card missed a kernel of {need}")
        lat, aud = gate(ref.latents, out.latents), gate(ref.audio, out.audio)
        cos, snr = lat if held == "latents" else aud
        log(f"small engine {name} (kernels x{scale:g}), card (kernels) vs CPU (plain): latents "
            f"cosine {lat[0]:.6f}, SNR {lat[1]:.2f} dB; audio cosine {aud[0]:.6f}, SNR "
            f"{aud[1]:.2f} dB; the gate on the {held} (cosine >= 0.999, SNR >= 26)")
        require(cos >= 0.999 and snr >= 26.0, f"card and CPU disagree on the small engine's {name}")


# ---------------------------------------------------------------------------
# rows 6 and 12 helpers
# ---------------------------------------------------------------------------

def check_int8(shape, seed) -> float:
    """Row 6 against its plain version on one shape (M, K, N): bit-identical
    bf16 outputs, a zero row and half-way ties included."""
    import torch
    from acestep_tpu_torch.ops.cuda import qmm_int8

    case = QmmCase("q8_0", *shape, seed)
    x = case.x.clone()
    x[0, :4] = torch.tensor([127.0, 0.5, -1.5, 2.5], device="cuda")
    if shape[0] > 2:
        x[2] = 0.0
    got = qmm_int8._launch(x, case.qt)
    again = qmm_int8._launch(x, case.qt)
    ref = qmm_int8.qmm_int8_act_plain(x, case.qt)
    require(bool(torch.isfinite(got.float()).all()), f"row 6 {shape}: non-finite output")
    same = bool(torch.equal(got, ref))
    log(f"  {qmm_int8.INT8.name} M={shape[0]} K={shape[1]} N={shape[2]}: bit-identical "
        f"{same}, max_abs_err {max_err(got, ref):.3e}, rerun bit-identical "
        f"{bool(torch.equal(got, again))}")
    require(same, f"row 6 {shape}: kernel differs from its plain version")
    require(bool(torch.equal(got, again)), f"row 6 {shape}: two launches on the same inputs differ")
    return max_err(got, ref)


def check_int8_stacked(seed) -> float:
    """Row 6 on layers 1 and 2 of a stacked 3-layer weight (qkv's shape), read
    in place (base + li layer strides): the plain version of the layer's view,
    bit for bit."""
    import torch
    from acestep_tpu_torch.ops.cuda import qmm_int8
    from acestep_tpu_torch.ops.qlinear import precast_quant_scales
    from acestep_tpu_torch.quant import quantize, stack_layers

    g = torch.Generator(device="cuda").manual_seed(seed)
    st = precast_quant_scales(stack_layers(
        [quantize(torch.randn((1024, 4096), generator=g, device="cuda") * 0.02, "q8_0")
         for _ in range(3)]))
    x = torch.randn((2, 1024), generator=g, device="cuda").bfloat16()
    for li in (1, 2):
        got = qmm_int8.qmm_int8_act(x, st, li)
        same = bool(torch.equal(got, qmm_int8.qmm_int8_act_plain(x, st.layer(li))))
        log(f"  {qmm_int8.INT8.name} stacked weight, layer {li} read in place: bit-identical "
            f"{same}")
        require(same, f"row 6 stacked layer {li}: kernel differs from its plain version")
    return 0.0


def int8_bound(m, k, n):
    """Least time of one row 6 launch: x, the weight as stored (int8 and an f16
    scale a 32-block) and the bf16 output once each; 2 M K N int8 operations."""
    return bound_ms(m * k * 2 + k * n * (1 + 2 / 32) + m * n * 2, 2.0 * m * k * n, INT8_OPS)


def dit_mega_case(cfg, n_layers, t, lc, seed, padded=False):
    """Random DiT decoder layers on the card (q8_0, fused, f32 scales; norms
    and the modulation table drawn, not constant) and one Euler step's inputs."""
    import torch
    from acestep_tpu_torch.models import dit
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.ops.qlinear import precast_quant_scales

    init = RandomInit(torch.device("cuda"), seed, "q8_0")
    h, d = cfg.hidden_size, cfg.head_dim

    def around_one(*shape):
        return (1.0 + 0.1 * init.normal(shape, 1.0)).bfloat16()

    sa, ca = init.attn(cfg, n_layers), init.attn(cfg, n_layers)
    for a in (sa, ca):
        a["q_norm"], a["k_norm"] = around_one(n_layers, d), around_one(n_layers, d)
    layers = {"self_attn_norm": around_one(n_layers, h), "self_attn": sa,
              "cross_attn_norm": around_one(n_layers, h), "cross_attn": ca,
              "mlp_norm": around_one(n_layers, h),
              "mlp": init.mlp(h, cfg.intermediate_size, n_layers),
              "scale_shift_table": (0.1 * init.normal((n_layers, 6, h), 1.0)).bfloat16()}
    layers = precast_quant_scales(dit.fuse_params({"layers": layers})["layers"])
    return layers, dit_mega_inputs(init, cfg, n_layers, t, lc, padded)


def dit_mega_inputs(init, cfg, n_layers, t, lc, padded=False):
    import torch
    from acestep_tpu_torch.ops import rope_cos_sin
    from acestep_tpu_torch.ops.cuda import dit_mega

    h, d, hkv = cfg.hidden_size, cfg.head_dim, cfg.num_key_value_heads
    x = init.normal((1, t, h), 1.0)
    kst, vst = (init.normal((n_layers, 1, hkv, lc, d), 1.0).bfloat16() for _ in range(2))
    tproj = init.normal((1, 6, h), 0.3)
    cos, sin = (a.bfloat16().float() for a in rope_cos_sin(
        torch.arange(t, device="cuda"), d, base=cfg.rope_theta))
    encm = torch.zeros((1, lc), device="cuda")
    if padded:
        encm[:, lc - lc // 5:] = dit_mega.NEG
    flags = [lt == "sliding_attention" for lt in cfg.layer_types[:n_layers]]
    return x, kst, vst, tproj, cos, sin, flags, encm


def dit_rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def dit_fault_args(fault, layers, args):
    """The plain version's inputs with the rule ``fault`` (one of DIT_FAULTS)
    broken: the band off on every layer, or gate_msa (mod[2] = sst[2] +
    tproj[2]) set to 1 by an f32 table that cancels tproj."""
    x, kst, vst, tproj, cos, sin, flags, encm = args
    if fault == "sliding band not applied":
        return layers, (x, kst, vst, tproj, cos, sin, [False] * len(flags), encm)
    sst = layers["scale_shift_table"].float().clone()
    sst[:, 2, :] = 1.0 - tproj.reshape(6, -1)[2]
    return dict(layers, scale_shift_table=sst), args


def check_dit_mega(full_cfg) -> float:
    """Row 12 against its plain version at full width (T 128, Lc 320) through
    the first 2 and all 24 layers, with and without padded condition tokens,
    at T 256 through 2 layers (padded), and a 2-layer case whose sliding
    window (16) masks, at DRIFT_FACTOR x the
    drift of the plain version (card against CPU) at that depth, never tighter
    than DIT_REL_MIN; reruns bit-identical; each planted fault rejected.
    Returns the max abs error."""
    import torch
    from acestep_tpu_torch import weights
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.models.stacking import first_layers
    from acestep_tpu_torch.ops.cuda import dit_mega

    name = dit_mega.MEGA.name
    n_full = full_cfg.num_hidden_layers
    t = time.perf_counter()
    layers24, _ = dit_mega_case(full_cfg, n_full, DIT_T, DIT_LC, 81)
    band_cfg = dataclasses.replace(full_cfg, sliding_window=16, num_hidden_layers=2,
                                   layer_types=full_cfg.layer_types[:2])
    layers_band, band_args = dit_mega_case(band_cfg, 2, DIT_T, DIT_LC, 82, padded=True)
    log(f"  {n_full}-layer and 2-layer random q8_0 decoders drawn in "
        f"{time.perf_counter() - t:.1f} s")
    init = RandomInit(torch.device("cuda"), 83, "q8_0")
    cases = []                  # (depth key, label, cfg, layers, args)
    for n_l in (2, n_full):
        cfg_d = dataclasses.replace(full_cfg, num_hidden_layers=n_l,
                                    layer_types=full_cfg.layer_types[:n_l])
        lay = first_layers(layers24, n_l)
        for padded in (False, True):
            cases.append((n_l, f"{name} {n_l} layers T={DIT_T} Lc={DIT_LC}"
                          f"{' padded' if padded else ''}", cfg_d, lay,
                          dit_mega_inputs(init, cfg_d, n_l, DIT_T, DIT_LC, padded)))
        if n_l == 2:            # 20.48 s: two GEMM passes of 128 tokens
            cases.append((2, f"{name} 2 layers T={DIT_T2} Lc={DIT_LC} padded", cfg_d, lay,
                          dit_mega_inputs(init, cfg_d, 2, DIT_T2, DIT_LC, True)))
    cases.append((2, f"{name} 2 layers T={DIT_T} Lc={DIT_LC} padded, window 16",
                   band_cfg, layers_band, band_args))
    err, runs, t_cpu = 0.0, [], 0.0
    for depth, label, cfg_d, lay, args in cases:
        t_tok = args[0].shape[1]
        require(dit_mega.supported(lay, cfg_d, 1, t_tok, DIT_LC), f"{label}: gate declines")
        got = dit_mega.dit_layers_mega(lay, cfg_d, *args)
        again = dit_mega.dit_layers_mega(lay, cfg_d, *args)
        require(bool(torch.equal(got, again)), f"{label}: two launches on the same inputs differ")
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        ref = dit_mega.dit_layers_mega_plain(lay, cfg_d, *args)
        t = time.perf_counter()
        cpu = dit_mega.dit_layers_mega_plain(
            weights.tree_to(lay, "cpu"), cfg_d,
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        t_cpu += time.perf_counter() - t
        drift = dit_rel(ref.cpu(), cpu)
        err = max(err, max_err(got, ref))
        runs.append((depth, label, cfg_d, lay, args, got, ref, drift))
        log(f"  {label}: plain on the card vs on the CPU: max err / peak {drift:.3e}")
    log(f"  (the plain version on the CPU took {t_cpu:.1f} s)")
    bounds = {d: max(DIT_REL_MIN, DRIFT_FACTOR * max(r[7] for r in runs if r[0] == d))
              for d in {r[0] for r in runs}}
    for depth, label, *_, got, ref, _ in runs:
        rel = dit_rel(got, ref)
        ok = rel < bounds[depth]
        log(f"  {label}: kernel vs plain max err / peak {rel:.3e} (< {bounds[depth]:.3e}) "
            f"max_abs_err {max_err(got, ref):.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"{label}: megakernel disagrees with its plain version")
    passed = []
    for fault in DIT_FAULTS:
        seen = []
        for depth, label, cfg_d, lay, args, got, ref, _ in runs:
            f_lay, f_args = dit_fault_args(fault, lay, args)
            rel = dit_rel(dit_mega.dit_layers_mega_plain(f_lay, cfg_d, *f_args), ref)
            seen.append(rel >= bounds[depth])
            log(f"  planted fault '{fault}', {label}: max err / peak {rel:.3e} -> "
                f"{'rejected' if seen[-1] else 'passes'}")
        if not any(seen):
            passed.append(fault)
    require(not passed, f"planted faults {passed} pass every megakernel check")
    return err


def dit_bound(cfg, t, lc):
    """Least time of one row 12 launch: the layers' q8_0 weights as stored
    (int8 and an f16 scale a 32-block), the norm and modulation tables, the
    cross K/V (bf16), x in and out (f32) and the step's small inputs once each;
    2 T FLOP a weight plus the attention's 4 T Lk D Hq a layer."""
    h, d, hq, hkv, inter = (cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads,
                            cfg.num_key_value_heads, cfg.intermediate_size)
    n_l, qdim = cfg.num_hidden_layers, hq * d
    kn = h * (qdim + 2 * hkv * d) + qdim * h + h * qdim + qdim * h + h * 2 * inter + inter * h
    nbytes = n_l * (kn * (1 + 2 / 32) + (3 * h + 6 * h + 3 * d) * 2 + 2 * hkv * lc * d * 2) \
        + 2 * t * h * 4 + 6 * h * 4 + 2 * t * d * 4 + lc * 4
    ops = n_l * (2.0 * t * kn + 4.0 * t * (t + lc) * d * hq)
    return bound_ms(nbytes, ops, BF16_FLOPS)


# ---------------------------------------------------------------------------
# long songs and configs[3]'s batch helpers
# ---------------------------------------------------------------------------

def blocked_case(t, seed, n_pad):
    """DiT-shaped self-attention inputs on the card: [2, 16 | 8, t, 128] bf16,
    item 1's last ``n_pad`` keys padded through kv_valid."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((2, 16, t, 128), generator=g, device="cuda").bfloat16()
    k = torch.randn((2, 8, t, 128), generator=g, device="cuda").bfloat16()
    v = torch.randn((2, 8, t, 128), generator=g, device="cuda").bfloat16()
    valid = torch.ones((2, t), dtype=torch.int32, device="cuda")
    valid[1, t - n_pad:] = 0
    return q, k, v, valid


def dense_attention(q, k, v, mask, rows: int = 1024):
    """ops.nn.attention in blocks of query rows (the same function row by row;
    the whole T x T score tensor of 7552 tokens would hold 7 GB)."""
    import torch
    from acestep_tpu_torch.ops.nn import attention

    return torch.cat([attention(q[:, :, i:i + rows], k, v, mask[:, :, i:i + rows])
                      for i in range(0, q.shape[2], rows)], dim=2)


def valid_rel(got, ref, n_pad) -> float:
    """Max abs error over the valid query rows (item 0's all, item 1's first
    T - n_pad) over their peak: a fully masked row averages a different set
    of keys in each function."""
    t = ref.shape[2]
    d = (got.float() - ref.float()).abs()
    err = max(float(d[0].max()), float(d[1, :, :t - n_pad].max()))
    peak = max(float(ref[0].float().abs().max()), float(ref[1, :, :t - n_pad].float().abs().max()))
    return err / peak


def flash_no_rescale(q, k, v, kv_valid, block_k=1024):
    """Planted fault: ops.blocked_attention.flash_attention with a block that
    skips its rescale (the running normaliser and accumulator keep their old
    maximum's scale)."""
    import torch
    from acestep_tpu_torch.ops.nn import NEG_INF

    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    nb = -(-tq // block_k)
    bias = torch.where(kv_valid.bool(), 0.0, NEG_INF).float()
    qg = q.reshape(b, hkv, hq // hkv, tq, d).float()
    m = torch.full((b, hkv, hq // hkv, tq, 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, tq, d), device=q.device)
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        s = torch.matmul(qg, k[:, :, None, blk].float().transpose(-1, -2)) / math.sqrt(d)
        s = s + bias[:, None, None, None, blk]
        m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m)
        l = l + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.matmul(p.to(q.dtype).float(), v[:, :, None, blk].float())
    return (acc / torch.clamp(l, min=1e-30)).reshape(b, hq, tq, d).to(q.dtype)


def check_long_attention(window: int) -> None:
    """banded_attention and flash_attention against dense masked attention on
    the card at the DiT's shapes (T 1536 and 7552), valid rows only, each held
    to its bound; a band one wider and a flash block without its rescale must
    each fail that bound."""
    import torch
    from acestep_tpu_torch.ops import blocked_attention as ba
    from acestep_tpu_torch.ops.nn import make_attention_mask

    for i, t in enumerate(LONG_T):
        q, k, v, valid = blocked_case(t, 70 + i, LONG_PAD)
        ref_band = dense_attention(q, k, v, make_attention_mask(t, t, kv_valid=valid,
                                                                sliding_window=window))
        ref_full = dense_attention(q, k, v, make_attention_mask(t, t, kv_valid=valid))
        band = ba.banded_attention(q, k, v, window, valid)
        flash = ba.flash_attention(q, k, v, valid)
        for label, got, ref, bound in (("banded", band, ref_band, BANDED_REL),
                                       ("flash", flash, ref_full, FLASH_REL)):
            require(bool(torch.isfinite(got).all()), f"{label} T={t}: non-finite output")
            rel = valid_rel(got, ref, LONG_PAD)
            log(f"  {label}_attention T={t} (Hq 16, Hkv 8, D 128, bf16, item 1 padded by "
                f"{LONG_PAD}) vs dense masked attention: max err / peak over valid rows "
                f"{rel:.3e} (<= {bound:.3e})")
            require(rel <= bound, f"{label}_attention T={t} disagrees with dense attention")
        for label, got, ref, bound in (
                ("a band one wider", ba.banded_attention(q, k, v, window + 1, valid),
                 ref_band, BANDED_REL),
                ("a flash block that skips its rescale", flash_no_rescale(q, k, v, valid),
                 ref_full, FLASH_REL)):
            rel = valid_rel(got, ref, LONG_PAD)
            log(f"  planted fault '{label}' T={t}: max err / peak {rel:.3e} -> "
                f"{'rejected' if rel > bound else 'passes'}")
            require(rel > bound, f"planted fault '{label}' passes at T={t}")
        times = {name: cuda_ms(fn, iters=3) for name, fn in (
            ("banded", lambda: ba.banded_attention(q, k, v, window, valid)),
            ("flash", lambda: ba.flash_attention(q, k, v, valid)))}
        log(f"  T={t}, B=2: banded {times['banded']:.3f} ms, flash {times['flash']:.3f} ms "
            f"a call (plain torch, f32 matmuls)")
        del q, k, v, ref_band, ref_full, band, flash
        free_engine()


def segments_vs_one_pass(engine, res, label: str) -> None:
    """The request's segments decoded again on the card must equal its result,
    and, reconciled, a one-pass decode (``pipeline.decode_one_pass``) of the
    same latents: bit for bit in a segment decoded at the global scale, within
    one int16 step in one re-quantized from its own."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline

    lat = torch.from_numpy(res.latents).to("cuda")
    plan = engine.plan(1, lat.shape[1])
    fetched = [(i16.cpu().numpy(), float(s)) for i16, s in
               pipeline.decode_segments(engine.vae_params, engine.vae_cfg, lat, plan)]
    again, scale = pipeline.reconcile_segments(fetched, 2)
    require(scale == res.audio_scale and all(
        np.array_equal(a, b) for a, b in zip(again, res.pcm16_segments())),
        f"{label}: the segments decoded again differ from the request's")
    whole, whole_scale = pipeline.decode_one_pass(engine.vae_params, engine.vae_cfg, lat, plan)
    whole = whole.cpu().numpy().reshape(1, -1, 2)
    worst, at = [], 0
    for (_, s_g), seg in zip(fetched, again):
        diff = np.abs(seg.astype(np.int32) - whole[:, at:at + seg.shape[1]].astype(np.int32))
        at += seg.shape[1]
        limit = 0 if s_g == scale else 1
        worst.append(int(diff.max()) - limit)
        log(f"  {label}: segment of {seg.shape[1]} samples at scale {s_g:.9g} vs one pass: max "
            f"diff {int(diff.max())} (<= {limit}), {int((diff > 0).sum())} samples differ")
    log(f"  {label}: scale one pass {float(whole_scale):.9g}, reconciled {scale:.9g}")
    require(at == whole.shape[1], f"{label}: segments cover {at} of {whole.shape[1]} samples")
    require(float(whole_scale) == scale and max(worst) <= 0,
            f"{label}: the reconciled segments disagree with the one-pass decode")


def gate(ref, got):
    """(cosine, SNR dB) of ``got`` against ``ref``: the Q8_0 gate's metrics, from
    the port's eval_metrics, once the two are of one shape and the reference
    is not silent (eval_metrics would cut the longer one and call two silent
    signals equal)."""
    import numpy as np

    from acestep_tpu_torch import eval_metrics

    require(ref.shape == got.shape, f"gate: the output's shape {got.shape} is not the "
            f"reference's {ref.shape}")
    ref, got = ref.ravel(), got.ravel()
    require(bool(np.any(ref != 0)), "gate: the reference is all zeros")
    return eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)



def serve_long(engine, dur, style, lyric, path):
    """One warm-up and one timed request of ``dur`` seconds, each launching
    every kernel of ``path``: exact length, finite, not silent, decoded in
    segments (10 at 600 s), both runs equal, and the segments against a
    one-pass decode.  Returns serve()'s results and counts."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline

    key = f"{dur:g}s q4_k"
    frames = pipeline.frames_for_duration(dur)
    bucket = pipeline.bucket_frames(frames)
    req = pipeline.GenerationRequest(duration_s=dur, style_token_ids=style,
                                     lyric_token_ids=lyric, seeds=[1])
    torch.cuda.reset_peak_memory_stats()
    results, counts = serve(engine, req, f"{dur:g} s at q4_k", 2, path)
    plan = engine.plan(1, frames)
    log(f"{key}: {frames} frames in a {bucket}-frame bucket "
        f"({bucket // engine.dit_cfg.patch_size} patch tokens); plan: chunk "
        f"{plan.vae_chunk_frames}, window batch {plan.vae_window_batch}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over its requests; launches a "
        "request: " + json.dumps({n: counts[0][n] for n in path}))
    n = frames * engine.vae_cfg.hop_length
    check_audio(results, n)
    require(all(r.audio_i16.shape == (1, n, 2) for r in results),
            f"{key}: audio_i16 of {[r.audio_i16.shape for r in results]}, {(1, n, 2)} expected")
    last = results[-1]
    n_seg = len(last.pcm16_segments())
    log(f"{key}: {n_seg} decode segments, vae_overlapped "
        f"{last.time_costs.get('vae_overlapped')}")
    require(last.time_costs.get("vae_overlapped") == 1.0 and n_seg >= 2,
            f"{key}: not decoded in segments")
    require(dur != 600.0 or n_seg == 10, f"{key}: {n_seg} segments, 10 expected")
    require(np.array_equal(results[0].audio_i16, last.audio_i16),
            f"two runs of the {key} request differ")
    segments_vs_one_pass(engine, last, key)
    return results, counts


def serve_configs3(engine, path):
    """configs[3]'s mix through the ContinuousBatcher, two passes: every future
    back with its own length, every kernel of ``path`` launched in each pass.
    Returns each pass's (launches, shapes) by name, for the recheck."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.serving.batcher import ContinuousBatcher

    hop = engine.vae_cfg.hop_length
    style = np.random.default_rng(1).integers(0, 150000, (1, 64))

    def run_merged(req):
        frames = pipeline.frames_for_duration(req.duration_s)
        plan = engine.plan(req.batch_size, frames)
        torch.cuda.reset_peak_memory_stats()
        res = engine.generate(req)
        log(f"  merged batch {list(req.durations_s)} s ({pipeline.bucket_frames(frames)}-frame "
            f"bucket): plan max_batch {plan.max_batch}, chunk {plan.vae_chunk_frames}, window "
            f"batch {plan.vae_window_batch}, detail {json.dumps(plan.detail)}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; time_costs "
            + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
        return res

    batcher = ContinuousBatcher(run_merged, max_batch=8, max_wait_s=0.3, pad_ratio=2.5,
                                max_batch_for=engine.max_batch_for_frames)
    served = {}
    batcher.start()
    try:
        for n_pass in range(2):
            reset_counts()
            done = len(batcher.stats["merged_sizes"])
            t = time.perf_counter()
            futs = [batcher.submit(pipeline.GenerationRequest(
                duration_s=d, style_token_ids=style, seeds=[i]))
                for i, d in enumerate(CONFIGS3_S)]
            outs = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t
            counts = served[f"configs[3] pass {n_pass}"] = snapshot_counts()
            log(f"configs[3] pass {n_pass}: {len(outs)} requests ({sum(CONFIGS3_S):g} s of "
                f"audio) in {wall:.3f} s wall, {sum(CONFIGS3_S) / wall:.2f} audio s per wall "
                f"s; merged sizes {list(batcher.stats['merged_sizes'])[done:]}; launches "
                + json.dumps({n: counts[0][n] for n in path}))
            require(all(counts[0][n] > 0 for n in path),
                    f"configs[3] pass {n_pass}: a kernel of the path was not launched")
            for i, (d, r) in enumerate(zip(CONFIGS3_S, outs)):
                n = pipeline.frames_for_duration(d) * hop
                require(r.audio_lengths == [n] and r.seeds == [i] and r.audio_i16.shape[0] == 1
                        and r.audio_i16.shape[1] >= n, f"configs[3] {d:g} s: audio_lengths "
                        f"{r.audio_lengths}, shape {r.audio_i16.shape}, seeds {r.seeds}")
                require(int(r.audio_i16[0, :n].max()) != int(r.audio_i16[0, :n].min()),
                        f"configs[3] {d:g} s: silent audio")
    finally:
        batcher.stop()
    return served


def merged_vs_solo(engine):
    """A merged 30 s item (its batch's bucket is 60 s's) against the same
    request alone and against itself beside another partner, all given the
    same noise (CUDA randn is not prefix-stable across sizes); then two
    planted merge faults.  Returns the requests' (launches, shapes), for the
    recheck.

    - Isolation: the item's latents beside a 60 s partner equal, bit for bit,
      its latents beside a 55 s one of another style and noise (one bucket,
      one set of shapes, so one set of kernel orders).
    - Solo: its latents within MERGE_LAT_DB of the request alone; the merged
      decode within the Q8_0 gate of its own latents decoded alone; the two
      requests' audio within MERGE_AUDIO_SLACK_DB of what those two
      differences explain together (one batch-1 decode of the two latents:
      the decode's magnification, measured here; and the merged decode's own).
    - Faults: each breaks the isolation; the one marked also fails
      MERGE_LAT_DB."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.serving.batcher import merge_requests

    hop, dev = engine.vae_cfg.hop_length, engine.device
    c = engine.dit_cfg.audio_acoustic_hidden_dim
    style, style2, style3 = (np.random.default_rng(s).integers(0, 150000, (1, 64))
                             for s in (1, 2, 3))
    solo = pipeline.GenerationRequest(duration_s=30.0, style_token_ids=style, seeds=[2])
    merged = merge_requests([solo, pipeline.GenerationRequest(
        duration_s=60.0, style_token_ids=style2, seeds=[4])])
    other = merge_requests([solo, pipeline.GenerationRequest(
        duration_s=55.0, style_token_ids=style3, seeds=[5])])
    # (request, whether the solo bound must see it too)
    faults = {"the item given its partner's valid length":
              (dataclasses.replace(merged, durations_s=[60.0, 60.0]), False),
              "the condition rows swapped":
              (dataclasses.replace(merged, style_token_ids=merged.style_token_ids[::-1].copy(),
                                   style_mask=merged.style_mask[::-1].copy()), True)}

    def randn(seed):
        return torch.randn((1, 1536, c), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))

    noise = torch.cat([randn(11), randn(12)])
    reset_counts()
    res_m = engine.generate(merged, noise=noise)
    res_o = engine.generate(other, noise=torch.cat([noise[:1], randn(13)]))
    res_s = engine.generate(solo, noise=noise[:1, :768])
    res_f = {label: engine.generate(req, noise=noise) for label, (req, _) in faults.items()}
    counts = snapshot_counts()
    n = pipeline.frames_for_duration(30.0)
    # a merged decode reads the padded latents past the item's end: compare up
    # to one decode overlap (64 frames) before it
    cut = (n - 64) * hop
    plan = engine.plan(1, n)

    def decode_alone(latents):
        """``latents`` [n, C] through the batch-1 one-pass decode, as f32."""
        i16, scale = pipeline.decode_one_pass(
            engine.vae_params, engine.vae_cfg,
            torch.from_numpy(np.ascontiguousarray(latents[None])).to(dev), plan)
        return i16.cpu().numpy().reshape(1, -1, 2)[0, :cut] / np.float32(float(scale))

    def isolated(res):
        """(equal, elements that differ) of the item's latents against its
        latents beside the other partner."""
        diff = int((res.latents[0, :n] != res_o.latents[0, :n]).sum())
        return diff == 0, diff

    iso = isolated(res_m)
    lat = gate(res_s.latents[0], res_m.latents[0, :n])
    same = gate(decode_alone(res_s.latents[0]), decode_alone(res_m.latents[0, :n]))
    dec = gate(decode_alone(res_m.latents[0, :n]), res_m.audio[0, :cut])
    audio = gate(res_s.audio[0, :cut], res_m.audio[0, :cut])
    # the latents' difference through one decode and the merged decode's own,
    # their difference powers added
    audio_bound = -10 * math.log10(10 ** (-same[1] / 10) + 10 ** (-dec[1] / 10)) \
        - MERGE_AUDIO_SLACK_DB
    log(f"merged 30 s item (bucket 1536) beside 60 s vs beside 55 s of another style and "
        f"noise: latents {'equal' if iso[0] else 'DIFFERENT'} ({iso[1]} elements differ)")
    log(f"the item vs the request alone (bucket 768), same noise, (cosine, SNR dB): latents "
        f"{lat[0]:.6f}, {lat[1]:.2f} (bound {MERGE_LAT_DB} dB); both latents through one "
        f"batch-1 decode, to 64 frames before the end: {same[0]:.6f}, {same[1]:.2f} (the "
        f"decode magnifies the latents' difference {lat[1] - same[1]:.2f} dB); the two "
        f"requests' audio there: {audio[0]:.6f}, {audio[1]:.2f} (bound {audio_bound:.2f} "
        f"dB); the merged decode vs the item's latents decoded "
        f"alone: {dec[0]:.6f}, {dec[1]:.2f} (>= 0.999, >= 26 dB)")
    rejected = {}
    for label, res in res_f.items():
        iso_f = isolated(res)
        lat_f = gate(res_s.latents[0], res.latents[0, :n])
        audio_f = gate(res_s.audio[0, :cut], res.audio[0, :cut])
        rejected[label] = not iso_f[0] and (lat_f[1] < MERGE_LAT_DB or not faults[label][1])
        log(f"  planted merge fault, {label}: isolation {iso_f[1]} elements differ; vs the "
            f"request alone: latents {lat_f[0]:.6f}, {lat_f[1]:.2f}, audio {audio_f[0]:.6f}, "
            f"{audio_f[1]:.2f}: {'rejected' if rejected[label] else 'NOT rejected'}")
    require(all(rejected.values()), f"a planted merge fault passes: {rejected}")
    require(iso[0], "a merged item's latents depend on its partner")
    require(dec[0] >= 0.999 and dec[1] >= 26.0,
            "a merged decode disagrees with the item's latents decoded alone")
    require(lat[1] >= MERGE_LAT_DB and audio[1] >= audio_bound,
            "a merged item disagrees with the same request served alone")
    return counts


# ---------------------------------------------------------------------------
# LM planner helpers
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """The byte-level tokenizer of tools/bench_full_pipeline.py:98-116: random
    weights need no real vocabulary, only the special ids of the LM's.  The
    code range is moved 26 ids down from the bench's [87669, 151669) so that it
    ends just below EOS (151643): the bench's range holds its own EOS and
    think-end ids, so the codes phase would count the forced EOS as a 601st
    code."""

    eos_token_id = 151643
    think_end_id = 151644
    audio_code_base_id = 151643 - 64000

    def encode(self, text):
        return [b % 50000 for b in text.encode()][:512]

    def decode(self, ids):
        out = []
        for i in ids:
            i = int(i)
            if i == self.think_end_id:
                out.append("</think>")
            elif i >= self.audio_code_base_id:
                out.append(f"<|audio_code_{i - self.audio_code_base_id}|>")
            else:
                out.append(chr(i % 94 + 32))
        return "".join(out)


def build_demo_vocab(size: int) -> list:
    """The demo tokenizer piece list of tools/bench_full_pipeline.py:19-50 (the
    port's copy, over the port's constrained constants): newline variants, the
    metadata field keys at several granularities, the numerals 0-999,
    keyscale / language / genre fragments, a caption word pool, then distinct
    filler pieces up to ``size``."""
    from acestep_tpu_torch.constrained import DEFAULT_GENRES, FIELD_ORDER, KEYS, LANGUAGES

    pieces = ["<eos>", "</think>", "\n", "\n\n", ": ", ":", " ", "<think>"]
    for f in FIELD_ORDER:
        pieces += [f, f + ":", f + ": ", "\n" + f, "\n" + f + ": ", f[:3], f[3:]]
    pieces += [str(n) for n in range(1000)]
    pieces += KEYS + [" major", " minor", "major", "minor", "m", "aj", "in", "or", "ajor",
                      "inor"]
    pieces += LANGUAGES
    for g in DEFAULT_GENRES:
        pieces += [g, g[:2], g[2:], " " + g]
    words = ["warm", "dream", "night", "synth", "drive", "slow", "deep", "neon", "rain", "city",
             "soft", "analog", "tape", "dust", "golden", "haze", "pulse", "wave", "drift", "glow"]
    pieces += words + [" " + w for w in words] + [",", ".", "!", "?", "'s"]
    for a in "abcdefghijklmnopqrstuvwxyz":
        pieces += [a, a.upper(), " " + a]
    seen, out = set(), []
    for p in pieces:
        if p not in seen:
            seen.add(p)
            out.append(p)
    i = 0
    while len(out) < size:
        out.append(f"\u00a7w{i}")          # distinct filler pieces
        i += 1
    return out[:size]


class DemoVocabTokenizer(ByteTokenizer):
    """ByteTokenizer over a demo vocabulary (``vocab_strs`` for the FSM; ids
    below the code range decode to their pieces), as the bench's --thinking
    row builds it, with ByteTokenizer's code range."""

    def __init__(self, vocab):
        self.vocab = vocab

    def vocab_strs(self):
        return self.vocab

    def decode(self, ids):
        out = []
        for i in ids:
            i = int(i)
            if i == self.think_end_id:
                out.append("</think>")
            elif i >= self.audio_code_base_id:
                out.append(f"<|audio_code_{i - self.audio_code_base_id}|>")
            elif 0 <= i < len(self.vocab):
                out.append(self.vocab[i])
        return "".join(out)


def replay_ok(ids, vocab, user_metadata, fsm_cfg) -> bool:
    """Do ``ids`` replay valid through the host MetadataFSM and end it?  Each
    token is checked with ``allowed_piece`` on its non-empty piece, which is
    ``MetadataFSM.allowed(vocab)[t]`` without the O(V) scan of a value state."""
    from acestep_tpu_torch import constrained

    fsm = constrained.MetadataFSM(fsm_cfg, user_metadata=user_metadata)
    for t in ids:
        piece = vocab[t]
        if fsm.done or not piece or not fsm.allowed_piece(piece):
            return False
        fsm.step(piece)
    return fsm.done


def random_cache(g, b, t_max, n_layers=28, hkv=8):
    import torch
    from acestep_tpu_torch.serving import kv_cache as kvc

    kq, ks = kvc.quantize_kv(torch.randn((n_layers, b, hkv, t_max, 128), generator=g,
                                         device="cuda"))
    vq, vs = kvc.quantize_kv(torch.randn((n_layers, b, hkv, t_max, 128), generator=g,
                                         device="cuda"))
    return kq, ks, vq, vs


def attn_case(b, lengths, seed, t_max=LM_T, hq=16, hkv=8):
    """Full-width inputs of rows 9 and 10 (16 query heads, 8 kv heads, 28
    layers of cache; under tensor parallelism a rank's hq / hkv)."""
    import torch
    from acestep_tpu_torch.serving import lm as lm_serving

    g = torch.Generator(device="cuda").manual_seed(seed)
    kq, ks, vq, vs = random_cache(g, b, t_max, hkv=hkv)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((b, h, 128), generator=g, device="cuda").bfloat16()
               for h in (hq, hkv, hkv))
    qn, kn = (torch.randn(128, generator=g, device="cuda") for _ in range(2))
    cos, sin = (t[:, 0] for t in lm_serving._rope_at(lens, 128, 1e6))
    return dict(q=q, k=k, v=v, qn=qn, kn=kn, cos=cos, sin=sin, cache=(kq, ks, vq, vs),
                lens=lens)


def attn_args(c, li):
    return (c["q"], *c["cache"], c["lens"], li, c["k"], c["v"])


def fused_args(c, li):
    return (c["q"], c["k"], c["v"], c["qn"], c["kn"], c["cos"], c["sin"], *c["cache"],
            c["lens"], li)


def mega_case(layers, b, lengths, seed, t_max=LM_T, n_layers=28):
    import torch
    from acestep_tpu_torch.serving import lm as lm_serving

    g = torch.Generator(device="cuda").manual_seed(seed)
    kq, ks, vq, vs = random_cache(g, b, t_max, n_layers)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    x0 = (torch.randn((b, 1024), generator=g, device="cuda") * 0.02).bfloat16()
    cos, sin = (t[:, 0] for t in lm_serving._rope_at(lens, 128, 1e6))
    return (kq, ks, vq, vs, lens, x0, cos, sin)


def sdpa_lib(c, li, n):
    """One ``scaled_dot_product_attention`` call on the dequantized bf16 layer
    ``li`` (first ``n`` positions) plus the self token, for a B = 1 case of
    :func:`attn_case` (the dequantization is made here, outside the call)."""
    import torch
    import torch.nn.functional as F

    kq, ks, vq, vs = c["cache"]
    k = torch.cat([(kq[li, :, :, :n].float() * ks[li, :, :, :n, None]).bfloat16(),
                   c["k"][:, :, None]], dim=2)
    v = torch.cat([(vq[li, :, :, :n].float() * vs[li, :, :, :n, None]).bfloat16(),
                   c["v"][:, :, None]], dim=2)
    q = c["q"][:, :, None]
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    except TypeError:       # an older torch: expand the kv heads outside the timing
        k2, v2 = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
        return lambda: F.scaled_dot_product_attention(q, k2, v2)


def check_attn_pair(label, got, ref, fused: bool) -> float:
    import torch

    if not fused:
        return check_close(label, got, ref, ATTN_TOL, ATTN_TOL)
    err = check_close(label, got[0], ref[0], ATTN_TOL, ATTN_TOL)
    d8 = max(int((got[i].int() - ref[i].int()).abs().max()) for i in (1, 3))
    sc = all(bool(torch.allclose(got[i], ref[i], rtol=2e-2, atol=1e-6)) for i in (2, 4))
    log(f"    new K/V int8 max diff {d8} (<= {INT8_MAX_DIFF}), scales within rtol 2e-2 {sc}")
    require(d8 <= INT8_MAX_DIFF and sc, f"{label}: new K/V disagree with the plain version")
    return err


def check_attn_at(shape, fused: bool, seed: int = 88) -> float:
    """Row 9 or 10 against its plain version at a (B, Hq, Hkv, T) a request
    launched (a rank's heads under TP; a planner's heads), lengths spread over
    [1, T - 1], at layers 0 and 27.  Returns the max abs error."""
    from acestep_tpu_torch.ops.cuda import decode_attn

    name = (decode_attn.FUSED if fused else decode_attn.ATTN).name
    b, hq, hkv, t_max = shape
    lengths = [max(1, (t_max - 1) * (i + 1) // b) for i in range(b)]
    c = attn_case(b, lengths, seed, t_max=t_max, hq=hq, hkv=hkv)
    err = 0.0
    for li in (0, 27):
        tag = f"{name} B={b} Hq={hq} Hkv={hkv} T={t_max} lengths={lengths} layer {li}"
        if fused:
            got = decode_attn.decode_attention_fused_stacked(*fused_args(c, li))
            ref = decode_attn.decode_attention_fused_plain(*fused_args(c, li))
        else:
            got = decode_attn.decode_attention_int8_stacked(*attn_args(c, li))
            ref = decode_attn.decode_attention_plain(*attn_args(c, li))
        err = max(err, check_attn_pair(tag, got, ref, fused))
    return err


def mega_diff(got, ref, gap_rel: float):
    """How far two megakernel outputs part: x max err / peak of ``ref``, the
    share of x equal, K/V int8 max diff, the scales' largest error beyond 1e-6
    relative to ``ref``'s, and (rows with the same argmax, rows whose top-1 /
    top-2 gap in ``ref`` is at least ``gap_rel`` of the peak)."""
    import torch

    x, xr = got[0].float(), ref[0].float()
    peak = float(xr.abs().max())
    top2 = torch.topk(xr, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) >= gap_rel * peak
    same = (x.argmax(-1) == xr.argmax(-1))[sure]
    return dict(
        rel=float((x - xr).abs().max()) / peak, x_equal=float((x == xr).float().mean()),
        int8=max(int((got[i].int() - ref[i].int()).abs().max()) for i in (1, 3)),
        kv_equal=min(float((got[i] == ref[i]).float().mean()) for i in (1, 3)),
        scale=max(float(((got[i] - ref[i]).abs() - 1e-6).clamp(min=0).div(
            ref[i].abs().clamp(min=1e-30)).max()) for i in (2, 4)),
        argmax=(int(same.sum()), int(sure.sum())), finite=bool(torch.isfinite(x).all()))


def mega_bounds(drift):
    """Bounds (x max err / peak, K/V int8 max diff, scales rel err, least share
    of x equal, of K/V int8 equal) at DRIFT_FACTOR x the drift readings, the
    errors never tighter than the JAX test's."""
    f = DRIFT_FACTOR
    return (max(MEGA_REL, f * max(d["rel"] for d in drift)),
            max(INT8_MAX_DIFF, math.ceil(f * max(d["int8"] for d in drift))),
            max(SCALE_RTOL, f * max(d["scale"] for d in drift)),
            1.0 - f * (1.0 - min(d["x_equal"] for d in drift)),
            1.0 - f * (1.0 - min(d["kv_equal"] for d in drift)))


def mega_passes(d, bounds) -> bool:
    rel_max, int8_max, sc_rtol, x_equal, kv_equal = bounds
    return (d["rel"] < rel_max and d["argmax"][0] == d["argmax"][1] and d["int8"] <= int8_max
            and d["scale"] <= sc_rtol and d["x_equal"] >= x_equal
            and d["kv_equal"] >= kv_equal and d["finite"])


def mega_line(d) -> str:
    return (f"x max err / peak {d['rel']:.3e}, argmax equal {d['argmax'][0]}/{d['argmax'][1]} "
            f"rows, K/V int8 max diff {d['int8']}, scales rel err {d['scale']:.2e}, equal: "
            f"x {d['x_equal']:.4f} K/V int8 {d['kv_equal']:.4f}")


def mega_plain_faulty(layers, cfg, fault, cache_k, cache_ks, cache_v, cache_vs, lengths,
                      x0, cos, sin):
    """decode_layers_mega_plain with the rule ``fault`` (one of MEGA_FAULTS)
    broken, everything else as there."""
    import torch
    from acestep_tpu_torch.ops.cuda.decode_mega import NEG, _bf, _rms, _weights
    from acestep_tpu_torch.ops.nn import rotate_half
    from acestep_tpu_torch.quant import dequantize
    from acestep_tpu_torch.quant.kv import quantize_kv

    n_layers, _, hkv, t_max, d = cache_k.shape
    b, hq, inter, eps = x0.shape[0], cfg.num_attention_heads, cfg.intermediate_size, \
        cfg.rms_norm_eps
    g, qdim, kvdim, nch = hq // hkv, hq * d, hkv * d, t_max // 128

    def mm(x, w, li):
        return x @ dequantize(w.layer(li), torch.bfloat16).float()

    res = (lambda t: t) if fault == "residual kept in f32" else _bf
    wqkv, wo, wgu, wdn = _weights(layers)
    cos, sin = cos.float()[:, None, :], sin.float()[:, None, :]
    valid = (torch.arange(t_max, device=x0.device)[None, :] < lengths[:, None])[:, None, None]
    x, outs = x0.float(), []
    for li in range(n_layers):
        qkv = mm(_bf(_rms(x, layers["input_norm"][li], eps)), wqkv, li)
        if fault == "qkv rounded to bf16":
            qkv = _bf(qkv)
        q = _rms(qkv[:, :qdim].reshape(b, hq, d), layers["q_norm"][li], eps)
        k = _rms(qkv[:, qdim:qdim + kvdim].reshape(b, hkv, d), layers["k_norm"][li], eps)
        v = qkv[:, qdim + kvdim:].reshape(b, hkv, d)
        q, k = q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
        outs.append((*quantize_kv(k), *quantize_kv(v)))
        qg = q.reshape(b, hkv, g, d)
        s = torch.einsum("bhgd,bhtd->bhgt", _bf(qg), cache_k[li].float())
        s = torch.where(valid, s * (1.0 / math.sqrt(d)) * cache_ks[li][:, :, None, :], NEG)
        s_self = (qg * k[:, :, None, :]).sum(-1) * (1.0 / math.sqrt(d))
        if fault == "self term dropped":
            s_self = torch.full_like(s_self, NEG)
        m = torch.maximum(s.amax(-1), s_self)
        vs = cache_vs[li][:, :, None, :]
        if fault == "probabilities against the chunk max":
            sc = s.view(b, hkv, g, nch, 128)
            mc = sc.amax(-1, keepdim=True)
            e = torch.where(valid.view(b, 1, 1, nch, 128), torch.exp(sc - mc), 0.0)
            p = _bf(e * vs.view(b, hkv, 1, nch, 128)) * torch.exp(mc - m[..., None, None])
            e = (e * torch.exp(mc - m[..., None, None])).view(s.shape)
            p = p.view(s.shape)
        else:
            e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            p = _bf(e * vs)
        e_self = torch.exp(s_self - m)
        o = torch.einsum("bhgt,bhtd->bhgd", p, cache_v[li].float())
        o = (o + e_self[..., None] * v[:, :, None, :]) / (e.sum(-1) + e_self)[..., None]
        x = res(x + mm(_bf(o.reshape(b, qdim)), wo, li))
        gu = mm(_bf(_rms(x, layers["post_norm"][li], eps)), wgu, li)
        act = _bf(_bf(gu[:, :inter] * torch.sigmoid(gu[:, :inter])) * _bf(gu[:, inter:]))
        x = res(x + mm(act, wdn, li))
    return (x, *(torch.stack([o[i] for o in outs]) for i in range(4)))


def check_mega(check_layers, cfg):
    """Row 11 against its plain version at the 0.6B shapes through the first 2
    and all 28 layers, at the bounds ``mega_bounds`` derives from this run's
    drift of the plain version (card against CPU) at that depth; argmax equal
    in every row at 2 layers, at 28 where the plain row's top-1 / top-2 gap is
    at least the x bound; reruns bit-identical.  Then the planted faults: each
    must fail the check at one of the two depths.  Returns (the x max abs
    error, the bounds at all the layers, the (B, T) shapes checked, the
    drift at all the layers: x max err / peak, card against CPU)."""
    import torch
    from acestep_tpu_torch import weights
    from acestep_tpu_torch.models.stacking import first_layers
    from acestep_tpu_torch.ops.cuda import decode_mega

    name = decode_mega.MEGA.name
    cases = ((1, [1]), (1, [128]), (1, [901]), (4, [1, 128, 555, 1407]),
             (8, [1, 128, 129, 640, 1000, 1300, 1406, 1407]))
    depths = {2: (dataclasses.replace(cfg, num_hidden_layers=2), first_layers(check_layers, 2)),
              cfg.num_hidden_layers: (cfg, check_layers)}
    cpu_layers = weights.tree_to(check_layers, "cpu")
    err, t_cpu, last = 0.0, 0.0, {}
    runs = {n_l: [] for n_l in depths}          # (label, kernel, plain, plain on the CPU)
    for i, (b, lengths) in enumerate(cases):
        for n_l, (cfg_d, layers_d) in depths.items():
            args = mega_case(layers_d, b, lengths, 70 + i, n_layers=n_l)
            label = f"{name} {n_l} layers B={b} T={LM_T} lengths={lengths}"
            require(decode_mega.supported(layers_d, cfg_d, b, LM_T),
                    f"megakernel gate refuses B={b} T={LM_T}")
            got = decode_mega.decode_layers_mega(layers_d, cfg_d, *args)
            again = decode_mega.decode_layers_mega(layers_d, cfg_d, *args)
            require(all(bool(torch.equal(a, c)) for a, c in zip(got, again)),
                    f"{label}: two launches on the same inputs differ")
            # the plan fixes the order of every sum: another grid, or any rerun,
            # gives the same bits (a race or a timing-dependent order would not)
            for grid in (132, 199):
                other = decode_mega.decode_layers_mega(layers_d, cfg_d, *args, grid=grid)
                require(all(bool(torch.equal(a, c)) for a, c in zip(got, other)),
                        f"{label}: a {grid}-block grid differs from the occupancy grid")
            reruns = 20 if (n_l, b) == (cfg.num_hidden_layers, 4) else 0
            for _ in range(reruns):
                again = decode_mega.decode_layers_mega(layers_d, cfg_d, *args)
                require(all(bool(torch.equal(a, c)) for a, c in zip(got, again)),
                        f"{label}: a rerun differs")
            log(f"  {label}: grids of 132 and 199 blocks{' and 20 reruns' if reruns else ''} "
                "bit-identical with the occupancy grid")
            ref = decode_mega.decode_layers_mega_plain(layers_d, cfg_d, *args)
            err = max(err, max_err(got[0], ref[0]))
            t = time.perf_counter()
            cpu = decode_mega.decode_layers_mega_plain(
                first_layers(cpu_layers, n_l), cfg_d, *(a.cpu() for a in args))
            t_cpu += time.perf_counter() - t
            runs[n_l].append((label, got, ref, cpu))
            last[n_l] = (args, ref)             # the faults run on the last case (B = 8)
    bounds, drifts = {}, {}
    for n_l, rs in runs.items():
        drift = [mega_diff([a.cpu() for a in ref], cpu, 0.0) for _, _, ref, cpu in rs]
        drifts[n_l] = max(d["rel"] for d in drift)
        for (label, *_), d in zip(rs, drift):
            log(f"  {label}: plain on the card vs on the CPU: {mega_line(d)}")
        bounds[n_l] = mega_bounds(drift)
        log(f"  {n_l} layers, bounds at {DRIFT_FACTOR} x that drift: x max err / peak < "
            f"{bounds[n_l][0]:.3e}, K/V int8 <= {bounds[n_l][1]}, scales rel err <= "
            f"{bounds[n_l][2]:.2e}, equal: x >= {bounds[n_l][3]:.4f} K/V int8 >= "
            f"{bounds[n_l][4]:.4f}; argmax equal "
            f"{'in every row' if n_l == 2 else 'where the top-1/top-2 gap >= the x bound'}")
    log(f"  (the plain version on the CPU took {t_cpu:.1f} s)")
    for n_l, rs in runs.items():
        for label, got, ref, _ in rs:
            d = mega_diff(got, ref, 0.0 if n_l == 2 else bounds[n_l][0])
            ok = mega_passes(d, bounds[n_l])
            log(f"  {label}: {mega_line(d)} {'ok' if ok else 'FAIL'}")
            require(ok, f"{label}: megakernel disagrees with its plain version")
    passed = []
    for fault in MEGA_FAULTS:
        seen = []
        for n_l, (cfg_d, layers_d) in depths.items():
            args, ref = last[n_l]
            d = mega_diff(mega_plain_faulty(layers_d, cfg_d, fault, *args), ref,
                          0.0 if n_l == 2 else bounds[n_l][0])
            seen.append(not mega_passes(d, bounds[n_l]))
            log(f"  planted fault '{fault}', {n_l} layers B=8: {mega_line(d)} -> "
                f"{'rejected' if seen[-1] else 'passes'}")
        if not any(seen):
            passed.append(fault)
    require(not passed, f"planted faults {passed} pass both megakernel checks")
    return (err, bounds[cfg.num_hidden_layers], {(b, LM_T) for b, _ in cases},
            drifts[cfg.num_hidden_layers])


def check_mega_shape(layers, cfg, bounds, shape, seed) -> float:
    """Row 11 against its plain version at one (B, T) that a request launched,
    through all the layers of ``layers``, held to ``bounds`` (check_mega's at
    that depth; argmax equal where the plain row's top-1 / top-2 gap is at
    least the x bound); lengths spread over [1, T - 1].  Returns the x max abs
    error."""
    from acestep_tpu_torch.ops.cuda import decode_mega

    b, t_max = shape
    lengths = [max(1, (t_max - 1) * (i + 1) // b) for i in range(b)]
    label = f"{decode_mega.MEGA.name} {cfg.num_hidden_layers} layers B={b} T={t_max} " \
            f"lengths={lengths}"
    require(decode_mega.supported(layers, cfg, b, t_max), f"megakernel gate refuses {label}")
    args = mega_case(layers, b, lengths, seed, t_max=t_max, n_layers=cfg.num_hidden_layers)
    got = decode_mega.decode_layers_mega(layers, cfg, *args)
    ref = decode_mega.decode_layers_mega_plain(layers, cfg, *args)
    d = mega_diff(got, ref, bounds[0])
    ok = mega_passes(d, bounds)
    log(f"  {label}: {mega_line(d)} {'ok' if ok else 'FAIL'}")
    require(ok, f"{label}: megakernel disagrees with its plain version")
    return max_err(got[0], ref[0])


def lm_weight_bytes(cfg):
    """Bytes of the layers' q8_0 weights as stored (int8 + f16 scale per 32)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    qdim, kvdim = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    kn = h * (qdim + 2 * kvdim) + qdim * h + h * 2 * inter + inter * h
    return cfg.num_hidden_layers * kn * (1 + 2 / 32), cfg.num_hidden_layers * kn


def attn_bound(b, n, fused):
    """Least time of one row 9 / 10 launch at valid length n: the valid K/V
    rows and scales, q, the self K/V, the output (and the fused prologue's
    extra inputs and outputs) once each; 4 x B x Hq x n x D operations."""
    nbytes = b * 8 * n * (128 + 4) * 2 + b * (16 * 128 * 2 + 2 * 8 * 128 * 2 + 16 * 128 * 4) + 4 * b
    if fused:
        nbytes += 2 * 128 * 4 + b * 2 * 128 * 4 + b * 2 * 8 * (128 + 4)
    return bound_ms(nbytes, 4.0 * b * 16 * n * 128, BF16_FLOPS)


def mega_bound(cfg, b, lengths):
    """Least time of one megakernel launch: the layers' q8_0 weights as stored,
    the norm weights, the valid K/V rows and scales of every layer, x in and
    out, the new K/V once each; 2 x B FLOP per weight and the attention's
    4 x B x Hq x n x D per layer."""
    stored, kn = lm_weight_bytes(cfg)
    n_l, h = cfg.num_hidden_layers, cfg.hidden_size
    kv = sum(n_l * 8 * n * (128 + 4) * 2 for n in lengths)
    nbytes = stored + n_l * (2 * h + 2 * 128) * 4 + kv + b * (h * 2 + 2 * 128 * 4 + h * 4) \
        + n_l * b * 8 * (128 + 4) * 2
    ops = 2.0 * b * kn + sum(4.0 * n_l * 16 * n * 128 for n in lengths)
    return bound_ms(nbytes, ops, BF16_FLOPS)


def lm_request(pipe, label, need, kw, duration=LM_DURATION_S):
    """One LM request through generate_with_stop_condition with the counts set
    to 0 just before it and read just after; checks the codes contract
    (``duration`` x 5 codes)."""
    import numpy as np

    n_codes = int(round(duration * 5))
    reset_counts()
    res = pipe.generate_with_stop_condition(LM_CAPTION, LM_LYRICS, duration, **kw)
    counts, shapes = snapshot_counts()
    log(f"{label}: time_costs " + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
    log(f"{label}: launches " + json.dumps({k: v for k, v in counts.items() if v}))
    require(all(counts[n] > 0 for n in need), f"{label}: a kernel of the path was not "
            f"launched (need {need}, got {counts})")
    for c in res.candidates:
        require(len(c) == n_codes and c.dtype == np.int32 and int(c.min()) >= 0
                and int(c.max()) < 64000,
                f"{label}: codes {len(c)} in [{c.min()}, {c.max()}] (need {n_codes} "
                f"in [0, 64000))")
    log(f"{label}: {len(res.candidates)} x {n_codes} codes in [0, 64000); first "
        f"{res.code_indices[:6].tolist()}")
    return res, counts, shapes


# ---------------------------------------------------------------------------
# the servers (phase server)
# ---------------------------------------------------------------------------

def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def http(port, path, body=None, raw=False):
    """One request to a server on this host: (status, JSON or raw bytes)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            out = r.read()
            return r.status, (out if raw else json.loads(out))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_job(port, payload, label, poll_s=POLL_S):
    """A job through /release_task, polled on /query_result until it ends:
    (result, wall seconds from submit to the completed poll, task id, the
    kernel counts reset just before the job and read just after it).  A poll
    every ``poll_s``: each one is a request the server's threads answer while
    the engine's host-paced launches run, so a tighter loop slows the job."""
    reset_counts()
    t = time.perf_counter()
    code, sub = http(port, "/release_task", payload)
    require(code == 200, f"{label}: /release_task answered {code}")
    while True:
        _, out = http(port, "/query_result", {"task_id": sub["task_id"]})
        if out["status"] in ("completed", "failed"):
            break
        time.sleep(poll_s)
    wall = time.perf_counter() - t
    counts = snapshot_counts()
    require(out["status"] == "completed", f"{label}: job failed: {out['error']}")
    return out["result"], wall, sub["task_id"], counts


class CaughtEngine:
    """Records every request ``engine.generate`` is handed (and its result),
    so a served job can be replayed through the engine directly."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []

    def __enter__(self):
        from acestep_tpu_torch import pipeline

        def catch(req, **kw):
            res = pipeline.AceStepEngine.generate(self.engine, req, **kw)
            self.calls.append((req, res))
            return res

        self.engine.generate = catch
        return self

    def __exit__(self, *exc):
        del self.engine.generate

    def direct(self):
        """The last caught request through ``AceStepEngine.generate`` again:
        (result, seconds)."""
        from acestep_tpu_torch import pipeline

        req = self.calls[-1][0]
        sync()
        t = time.perf_counter()
        res = pipeline.AceStepEngine.generate(self.engine, req)
        return res, time.perf_counter() - t


def lora_adapter(base, seed, dev):
    """A rank-16 adapter (b non-zero) on every attention / MLP kernel of the
    unstacked DiT tree ``base``, as the JAX package's ``init_lora`` targets
    them, drawn on ``dev``."""
    import re

    import torch
    from acestep_tpu_torch.quant import QuantTensor

    targets = re.compile(r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$")
    g = torch.Generator(device=dev).manual_seed(seed)

    def walk(t, path):
        if isinstance(t, dict):
            out = {k: walk(v, f"{path}/{k}") for k, v in t.items()}
            return {k: v for k, v in out.items() if v is not None} or None
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        if targets.search(path) and (isinstance(t, QuantTensor) or t.dim() == 2):
            k, n = t.shape
            return {"a": torch.randn((k, LORA_RANK), generator=g, device=dev) / LORA_RANK,
                    "b": torch.randn((LORA_RANK, n), generator=g, device=dev) * 0.02}
        return None

    return walk(base, "")


@contextlib.contextmanager
def plain_qmm():
    """The dequant-matmul's plain version for CUDA tensors too, inside the
    block (the alignment probe's drift measure, as check_mega's plain runs)."""
    from acestep_tpu_torch.ops.cuda import qmm

    real = qmm.qmm

    def plain(x, qt, bias=None, out_dtype=None, li=None):
        return qmm.qmm_plain(x, qt if li is None else qt.layer(li), bias, out_dtype)

    qmm.qmm = plain
    try:
        yield
    finally:
        qmm.qmm = real


def probe_card_vs_cpu(dit_cfg, vae_cfg, text_cfg, need, dev="cuda"):
    """The alignment probe on a small engine (phase output_audio's configs) on
    the card (kernels) against the same engine on the CPU (plain versions),
    30 s of random latents, the same eps: the kernel run held to DRIFT_FACTOR
    times the drift of the plain version on the card against the CPU, never
    tighter than PROBE_ATOL (the probe's parity bound against the JAX
    package, tests/test_torch_alignment.py).  Returns (error, bound)."""
    import numpy as np
    import torch

    from acestep_tpu_torch import alignment, pipeline, weights

    cpu = pipeline.build_random_engine(device="cpu", quant="q8_0", seed=3, dit_cfg=dit_cfg,
                                       vae_cfg=vae_cfg, text_cfg=text_cfg)
    gpu = pipeline.AceStepEngine(
        weights.tree_to(cpu.dit_params, dev), dit_cfg, weights.tree_to(cpu.vae_params, dev),
        vae_cfg, weights.tree_to(cpu.text_params, dev), text_cfg, device=dev)
    rng = np.random.default_rng(8)
    t_valid = pipeline.frames_for_duration(SERVER_A_S)
    lat = rng.standard_normal((1, t_valid, dit_cfg.audio_acoustic_hidden_dim)).astype(np.float32)
    req = pipeline.GenerationRequest(duration_s=SERVER_A_S, seeds=[1],
                                     style_token_ids=rng.integers(0, 512, (1, 20)),
                                     lyric_token_ids=rng.integers(0, 512, (1, 40)))
    eps = torch.randn((1, pipeline.bucket_frames(t_valid), dit_cfg.audio_acoustic_hidden_dim),
                      generator=torch.Generator().manual_seed(7))
    ref, n = cpu.lyric_attention_map(lat, req, eps)
    with plain_qmm():
        plain, _ = gpu.lyric_attention_map(lat, req, eps)
    before = snapshot_counts()[0]
    got, _ = gpu.lyric_attention_map(lat, req, eps)
    again, _ = gpu.lyric_attention_map(lat, req, eps)
    after = snapshot_counts()[0]
    require(all(after[k] > before[k] for k in need), f"the small probe on the card missed {need}")
    drift, err = float(np.abs(plain - ref).max()), float(np.abs(got - ref).max())
    bound = max(DRIFT_FACTOR * drift, PROBE_ATOL)
    s_ref, s_got = alignment.alignment_score(ref, n), alignment.alignment_score(got, n)
    log(f"alignment probe, small engine ({dit_cfg.hidden_size} wide, {dit_cfg.num_hidden_layers} "
        f"layers, q8_0, 30 s): card (kernels) vs CPU (plain) maps max abs err {err:.3e}; drift of "
        f"the plain version card vs CPU {drift:.3e}; bound {bound:.3e} (1.5x the drift, never "
        f"below {PROBE_ATOL:g}); score {s_got:.6f} vs {s_ref:.6f}; rerun bit-identical "
        f"{bool(np.array_equal(got, again))}")
    require(err <= bound and np.isfinite(got).all(), "the probe's card maps disagree with the CPU")
    require(np.array_equal(got, again), "two probe runs on the card differ")
    return err, bound


def serve_http(engine, dit_tree, pipe, src_wave, refer_wave, names, mega_name, small_cfgs):
    """Phase server: phase full's engine saved as a checkpoint and read back
    through ``serving.launch.build_engine``, then the REST server (engine
    alone, and the whole pipeline with the LM), the OpenRouter server and the
    LoRA routes over HTTP, each job held bit for bit against the engine
    called directly on the request the server built.  Returns {label:
    (launches, shapes)} of the served jobs."""
    import base64

    import numpy as np
    import torch

    from acestep_tpu_torch import inference, loader, pipeline, weights
    from acestep_tpu_torch.lora_runtime import LoRARuntime
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.serving import launch
    from acestep_tpu_torch.serving.api_server import ApiServer
    from acestep_tpu_torch.serving.openrouter_server import OpenRouterServer
    from acestep_tpu_torch.training.lora import apply_lora
    from acestep_tpu_torch.utils import audio as audio_io
    from acestep_tpu_torch.utils import flac, mp3

    t_phase = time.perf_counter()
    served, secs = {}, {}
    sr = AUDIO_SR
    work = tempfile.TemporaryDirectory(prefix="acestep_server_")
    os.environ["ACESTEP_TPU_PROGRESS_CACHE"] = os.path.join(work.name, "progress_eta.json")
    # the checkpoint: the DiT as a checkpoint holds it (unstacked layers)
    t = time.perf_counter()
    ckpt = os.path.join(work.name, "ckpt")
    os.makedirs(ckpt)
    tree = dict(dit_tree, layers=unstack_layer_params(dit_tree["layers"]))
    for name, params, cfg in (("dit", tree, engine.dit_cfg), ("vae", engine.vae_params,
                                                              engine.vae_cfg),
                              ("text_encoder", engine.text_params, engine.text_cfg)):
        loader.save_params(os.path.join(ckpt, name), params)
        with open(os.path.join(ckpt, f"{name}.config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
    secs["checkpoint save"] = time.perf_counter() - t
    size = sum(os.path.getsize(os.path.join(ckpt, p)) for p in os.listdir(ckpt))
    del tree
    t = time.perf_counter()
    engine, base = launch.build_engine(ckpt, device=engine.device)
    sync()
    secs["checkpoint read"] = time.perf_counter() - t
    log(f"full-width q4_k checkpoint ({size / 2**30:.2f} GiB) saved in "
        f"{secs['checkpoint save']:.2f} s, read back through build_engine in "
        f"{secs['checkpoint read']:.2f} s; the unstacked DiT tree has "
        f"{len(base['layers'])} layers")

    # the server's own upload decoding, timed where it runs
    decoded, real_decode = [], launch._decode_audio_payload

    def timed_decode(b64, fmt=""):
        t = time.perf_counter()
        out = real_decode(b64, fmt)
        decoded.append((out.shape[0] / sr, time.perf_counter() - t))
        return out

    launch._decode_audio_payload = timed_decode
    tok = ByteTokenizer()
    gen = launch.make_generate_fn(engine, tok)
    lora_rt = LoRARuntime(engine, base)
    api = ApiServer(gen, lora_runtime=lora_rt, api_key="")
    port = api.start("127.0.0.1", 0)
    full = ApiServer(launch.make_full_generate_fn(engine, pipe), api_key="")
    port_full = full.start("127.0.0.1", 0)
    orouter = OpenRouterServer(launch.openrouter_generate_fn(gen))
    port_or = orouter.start("127.0.0.1", 0)
    jobs = []                              # (label, wall s via HTTP, direct generate s)

    def held(label, job, caught, fmt):
        """The served audio against the caught request's direct run, bit for bit
        in the payload's own format."""
        result, wall, _, (counts, shapes) = job
        direct, direct_s = caught.direct()
        segs = [s[0] for s in direct.pcm16_segments()]
        pcm = np.concatenate(segs, axis=0)
        t = time.perf_counter()
        want = {"wav": lambda: audio_io.wav_bytes(segs, sr),
                "flac": lambda: flac.encode_flac(pcm, sr),
                "mp3": lambda: mp3.encode_mp3(pcm, sr)}[fmt]()
        secs[f"{fmt} encode ({label})"] = time.perf_counter() - t
        got = base64.b64decode(result["audio_base64"])
        require(result["audio_format"] == fmt and got == want,
                f"{label}: the served {fmt} differs from engine.generate on its request")
        served[f"server {label}"] = (counts, shapes)
        jobs.append((label, wall, direct_s))
        log(f"{label}: via HTTP {wall:.4f} s, engine.generate on the caught request "
            f"{direct_s:.4f} s; {fmt} ({len(got)} bytes) bit for bit equal; launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
        return direct

    with CaughtEngine(engine) as caught:
        # (a) text2music, 30 s, lyrics, LRC, FLAC out
        pay_a = {"caption": LM_CAPTION, "lyrics": LM_LYRICS, "duration": SERVER_A_S,
                 "seed": 1, "return_lrc": True, "audio_format": "flac"}
        job = http_job(port, pay_a, "request (a)")
        res_a, tid_a = job[0], job[2]
        direct_a = held("(a) 30 s text2music, return_lrc, FLAC", job, caught, "flac")
        req_a = caught.calls[-1][0]
        lines = [ln for ln in LM_LYRICS.split("\n") if ln.strip()]
        n_ids = int(req_a.lyric_token_ids.shape[1])
        per = max(1, n_ids // len(lines))
        counts = [per] * (len(lines) - 1) + [n_ids - per * (len(lines) - 1)]
        sync()
        t = time.perf_counter()
        stamps, lrc = engine.get_lyric_timestamps(direct_a.latents, req_a, lines, counts)
        score = engine.get_lyric_score(direct_a.latents, req_a)
        secs["alignment probe x2 (30 s)"] = time.perf_counter() - t
        require(lrc == res_a["lrc"] and [round(float(s), 3) for s in stamps]
                == res_a["lyric_timestamps"] and float(score) == res_a["lyric_score"],
                "(a): the served LRC / stamps / score differ from the direct probe")
        log(f"(a) lyric alignment at full width: score {res_a['lyric_score']:.6f}; LRC "
            + json.dumps(res_a["lrc"].split("\n")))
        code, lyr = http(port, "/v1/lyrics", {"task_id": tid_a})
        require(code == 200 and lyr["lrc"] == res_a["lrc"], f"/v1/lyrics answered {code}")

        # (b) repaint 20-40 s of the 60 s chord source, uploaded as WAV
        wav_src = base64.b64encode(audio_io.wav_bytes(src_wave, sr)).decode()
        pay_b = {"caption": LM_CAPTION, "lyrics": LM_LYRICS, "duration": SERVER_B_S, "seed": 1,
                 "task_type": "repaint", "src_audio_base64": wav_src,
                 "repaint_start": REPAINT_SPAN[0], "repaint_end": REPAINT_SPAN[1]}
        held("(b) 60 s repaint 20-40 s, WAV upload", http_job(port, pay_b, "request (b)"),
             caught, "wav")
        req_b = caught.calls[-1][0]
        secs["upload decode (60 s WAV, in the server)"] = decoded[-1][1]
        src_lat = engine.encode_src_audio(real_decode(wav_src))
        enc_err = float(np.abs(src_lat - req_b.src_latents).max() / np.abs(src_lat).max())
        log(f"(b) the server's src latents {req_b.src_latents.shape} against encode_src_audio "
            f"of the decoded upload: max err / peak {enc_err:.2e} (bit for bit "
            f"{bool(np.array_equal(src_lat, req_b.src_latents))}; held to 1e-5)")
        require(req_b.task == "repaint" and enc_err <= 1e-5, "(b): the upload's latents differ")

        # (c) cover at 0.5 of the source, the reference uploaded as FLAC
        t = time.perf_counter()
        flac_ref = base64.b64encode(flac.encode_flac(refer_wave, sr)).decode()
        secs["flac encode (40 s reference)"] = time.perf_counter() - t
        pay_c = dict(pay_b, task_type="cover", audio_cover_strength=COVER_STRENGTH,
                     refer_audio_base64=flac_ref)
        del pay_c["repaint_start"], pay_c["repaint_end"]
        held("(c) 60 s cover 0.5, FLAC reference", http_job(port, pay_c, "request (c)"),
             caught, "wav")
        req_c = caught.calls[-1][0]
        secs["upload decode (60 s WAV and 40 s FLAC, in the server)"] = [
            round(s, 4) for _, s in decoded[-2:]]
        require(req_c.task == "cover" and req_c.refer_latents.shape == (1, 1, 750, 64),
                f"(c): task {req_c.task}, refer {getattr(req_c.refer_latents, 'shape', None)}")

        # (d) MP3 out where the host has libmp3lame
        log(f"libmp3lame {'found' if mp3.encoder_available() else 'absent'}, libmpg123 "
            f"{'found' if mp3.decoder_available() else 'absent'} on this host")
        if mp3.encoder_available():
            held("(d) 10 s MP3", http_job(port, {"caption": LM_CAPTION, "duration": 10.0,
                                                 "seed": 2, "audio_format": "mp3"},
                                          "request (d)"), caught, "mp3")

        code, health = http(port, "/health")
        code_st, page = http(port, "/studio", raw=True)
        with open(os.path.join(os.path.dirname(os.path.abspath(pipeline.__file__)), "ui",
                               "studio.html"), "rb") as f:
            studio = f.read()
        code_s, stats = http(port, "/v1/stats")
        require(code == 200 and code_st == 200 and page == studio and code_s == 200
                and stats["completed"] >= 3, "/health, /studio or /v1/stats answered wrong")
        log(f"/health ok, /studio {len(page)} bytes (the port's page), /v1/stats: completed "
            f"{stats['completed']}, failed {stats['failed']}, job_wall "
            + json.dumps({k: round(v, 4) for k, v in stats["latency"]["job_wall"].items()}))

        # the whole pipeline: configs[2]'s song through the LM
        pay_f = {"caption": LM_CAPTION, "lyrics": LM_LYRICS, "duration": LM_DURATION_S,
                 "bpm": 100, "thinking": False, "seed": 0}
        res_f, wall, _, (counts_f, shapes_f) = http_job(port_full, pay_f, "full-pipeline request")
        res_f2, wall2, _, _ = http_job(port_full, pay_f, "full-pipeline request, tight poll",
                                       poll_s=0.002)
        params, config = launch.build_params(engine, pay_f, pipe.tok)
        sync()
        t = time.perf_counter()
        direct_f = inference.generate_music(engine, pipe, params, config)
        direct_s = time.perf_counter() - t
        want = audio_io.wav_bytes([s[0] for s in direct_f.dit_result.pcm16_segments()], sr)
        require(base64.b64decode(res_f["audio_base64"]) == want
                and res_f2["audio_base64"] == res_f["audio_base64"],
                "the full pipeline's served WAV differs from generate_music")
        require(counts_f[mega_name] > 0, f"the full-pipeline job did not run {mega_name}")
        served["server full pipeline"] = (counts_f, shapes_f)
        jobs.append(("configs[2] song, whole pipeline", wall, direct_s))
        jobs.append(("configs[2] song, polled every 0.002 s", wall2, direct_s))
        log(f"configs[2] song via HTTP (make_full_generate_fn): {wall:.4f} s polled every "
            f"{POLL_S} s, {wall2:.4f} s polled every 0.002 s, generate_music {direct_s:.4f} s; "
            f"WAV bit for bit equal; metadata {json.dumps(res_f['metadata'])}; "
            f"launches " + json.dumps({k: v for k, v in counts_f.items() if v}))

        # the OpenRouter server, a fenced metadata block
        msgs = [{"role": "user", "content": f"{LM_CAPTION}\nbpm: 100\nduration: 10\n{LM_LYRICS}"}]
        reset_counts()
        t = time.perf_counter()
        code, out = http(port_or, "/v1/chat/completions", {"messages": msgs})
        wall = time.perf_counter() - t
        served["server openrouter"] = snapshot_counts()
        require(code == 200, f"/v1/chat/completions answered {code}")
        direct, direct_s = caught.direct()
        chain = audio_io.wav_bytes(audio_io.read_wav_bytes(audio_io.wav_bytes(
            [s[0] for s in direct.pcm16_segments()], sr))[0], sr)
        got = base64.b64decode(out["choices"][0]["message"]["audio"]["data"])
        require(got == chain and caught.calls[-1][0].duration_s == 10.0,
                "the OpenRouter WAV differs from the direct request's after read_wav -> write_wav")
        jobs.append(("OpenRouter chat completion, 10 s", wall, direct_s))
        log(f"OpenRouter /v1/chat/completions (10 s): {wall:.4f} s, direct {direct_s:.4f} s; WAV "
            f"equal after read_wav -> write_wav; content {out['choices'][0]['message']['content']}")

        # LoRA through /v1/lora: register, activate, scale 0.5, deactivate
        pay_l = {"caption": LM_CAPTION, "lyrics": LM_LYRICS, "duration": 10.0, "seed": 3}
        base_res = http_job(port, pay_l, "LoRA base")[0]
        adapter = lora_adapter(base, 21, engine.device)
        loader.save_params(os.path.join(work.name, "adapter"), adapter)
        code, _ = http(port, "/v1/lora", {"action": "register", "name": "rand16", "alpha": 16.0,
                                          "path": os.path.join(work.name, "adapter")})
        require(code == 200, f"/v1/lora register answered {code}")
        runs = {}
        for action, body in (("activate", {}), ("scale", {"scale": 0.5}), ("deactivate", {})):
            sync()
            t = time.perf_counter()
            code, out = http(port, "/v1/lora", dict(body, action=action, name="rand16"))
            secs[f"LoRA {action}"] = time.perf_counter() - t
            require(code == 200, f"/v1/lora {action} answered {code}: {out}")
            runs[action], _, _, served[f"server LoRA {action}"] = http_job(port, pay_l,
                                                                        f"LoRA {action}")
        a0, a1, a2, a3 = (base64.b64decode(r["audio_base64"])
                          for r in (base_res, runs["activate"], runs["scale"], runs["deactivate"]))
        require(a1 != a0 and a2 != a1 and a2 != a0, "LoRA activate / scale left the audio as it was")
        require(a3 == a0, "LoRA deactivate did not restore the base's int16 bit for bit")
        log(f"LoRA rank {LORA_RANK} on every attention / MLP kernel: activate "
            f"{secs['LoRA activate']:.3f} s, scale 0.5 {secs['LoRA scale']:.3f} s, deactivate "
            f"{secs['LoRA deactivate']:.3f} s (each a merge of the whole DiT on the card and the "
            f"engine's layout rebuilt); the audio moved with activate and with scale, and "
            f"deactivate restored the base's int16 bit for bit")
    # the card's merge against the CPU's: two of layer 0's q4_k kernels
    sub = {"layers": [{"self_attn": {"q_proj": base["layers"][0]["self_attn"]["q_proj"]},
                       "mlp": {"down_proj": base["layers"][0]["mlp"]["down_proj"]}}]}
    sub_ad = {"layers": [{"self_attn": {"q_proj": adapter["layers"][0]["self_attn"]["q_proj"]},
                          "mlp": {"down_proj": adapter["layers"][0]["mlp"]["down_proj"]}}]}
    on_card = apply_lora(sub, sub_ad, alpha=16.0)
    t = time.perf_counter()
    on_cpu = apply_lora(weights.tree_to(sub, "cpu"), weights.tree_to(sub_ad, "cpu"), alpha=16.0)
    cpu_s = time.perf_counter() - t
    same = []
    for group, name in (("self_attn", "q_proj"), ("mlp", "down_proj")):
        c, w = on_card["layers"][0][group][name]["kernel"], on_cpu["layers"][0][group][name]["kernel"]
        same.append(c.fmt == w.fmt == "q4_k" and all(
            torch.equal(getattr(c, f).cpu(), a) for f, a in w.fields().items()))
    log(f"LoRA merge of layer 0's q4_k q_proj and down_proj: the card's fields equal the CPU's "
        f"bit for bit: {same} (CPU merge {cpu_s:.2f} s)")
    require(all(same), "the card's LoRA merge differs from the CPU's")
    for s in (api, full, orouter):
        s.stop()
    launch._decode_audio_payload = real_decode
    work.cleanup()

    probe_card_vs_cpu(*small_cfgs, [names["q8_0"]], engine.device)
    log("server path, wall s via HTTP against engine.generate on the caught request (the "
        "server's own cost is the difference): " + json.dumps(
            {label: [round(w, 4), round(d, 4), round(w - d, 4)] for label, w, d in jobs}))
    log("server path seconds: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v) for k, v in secs.items()}))
    log(f"phase server took {time.perf_counter() - t_phase:.1f} s")
    del engine, base, lora_rt
    return served


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_batch(dit_cfg, device, frames=TRAIN_T, lc=TRAIN_LC, masked=TRAIN_MASKED, seed=11):
    """A batch of 2 made with numpy: latents, the text2music context, ``lc``
    condition tokens (all valid), item 2's last ``masked`` frames out of the loss."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = {"latents": rng.standard_normal((2, frames, dit_cfg.audio_acoustic_hidden_dim)),
         "context_latents": rng.standard_normal((2, frames, dit_cfg.context_dim)),
         "encoder_hidden_states": rng.standard_normal((2, lc, dit_cfg.hidden_size)),
         "loss_mask": np.ones((2, frames))}
    b["loss_mask"][1, frames - masked:] = 0.0
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in b.items()}
    out["encoder_attn_mask"] = torch.ones((2, lc), dtype=torch.int32, device=device)
    return out


def list_tree(init, dit_cfg):
    """A DiT drawn by ``init`` as training takes it: per-layer (unfused) lists."""
    from acestep_tpu_torch.models.stacking import unstack_layer_params

    tree = init.dit(dit_cfg)
    tree["layers"] = unstack_layer_params(tree["layers"])
    return tree


def decoder_b_leaves(lora):
    return [leaf["kernel"]["b"] for layer in lora["layers"]
            for group in ("self_attn", "cross_attn", "mlp") for leaf in layer[group].values()
            if isinstance(leaf, dict) and isinstance(leaf.get("kernel"), dict)]


def same_trainer_state(a, b) -> bool:
    import torch

    from acestep_tpu_torch.weights import tree_leaves

    la = tree_leaves(a.trainable) + tree_leaves(a.opt_state.mu) + tree_leaves(a.opt_state.nu)
    lb = tree_leaves(b.trainable) + tree_leaves(b.opt_state.mu) + tree_leaves(b.opt_state.nu)
    return (a.step == b.step and a.opt_state.count == b.opt_state.count and len(la) == len(lb)
            and all(x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)
                    for x, y in zip(la, lb)))


def train_full_width(dit_cfg, work, device="cuda"):
    """Phase train: LoRA, LoKr and full steps of a full-width bf16 DiT through
    the Trainer; a LoRA checkpoint resumed bit for bit.  The full steps run
    last, on the drawn tree itself (this function drops its own reference and
    the base's snapshot first, so the peak is the trainer's alone).  Returns
    (the DiT tree after the full steps, stats by mode)."""
    import torch

    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.training.flow_matching import draw
    from acestep_tpu_torch.training.trainer import TrainConfig, Trainer
    from acestep_tpu_torch.weights import tree_leaves

    t = time.perf_counter()
    base = list_tree(RandomInit(torch.device(device), 7, None), dit_cfg)
    batch = train_batch(dit_cfg, device)
    snapshot = [x.clone() for x in tree_leaves(base)]
    sync()
    n_params = sum(x.numel() for x in snapshot)
    log(f"full-width bf16 DiT for training drawn in {time.perf_counter() - t:.1f} s: "
        f"{n_params / 1e9:.3f} B parameters in {len(snapshot)} leaves; batch 2 x "
        f"{TRAIN_T} frames, {TRAIN_LC} condition tokens, item 2's last {TRAIN_MASKED} frames "
        f"out of the loss")
    stats = {}
    for mode, steps in TRAIN_STEPS:
        if mode == "full":
            snapshot = None             # only the adapter modes check the base
        free_engine()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tc = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=100, mode=mode,
                         lora_rank=LORA_RANK, lora_alpha=16.0, lokr_factor=8,
                         checkpoint_every=0, log_every=1000)
        tr = Trainer(base, dit_cfg, tc, os.path.join(work, mode), seed=0, device=device)
        if mode == "full":
            base = None                 # the trainer holds the only reference
        n_train = sum(x.numel() for x in tree_leaves(tr.trainable))
        secs, losses = [], []
        for i in range(steps):
            sync()
            t = time.perf_counter()
            losses.append(tr.train_step(batch))
            sync()
            secs.append(time.perf_counter() - t)
            if mode == "lora" and i < 2:
                nonzero = [bool(x.any()) for x in decoder_b_leaves(tr.trainable)]
                require(nonzero and all(nonzero) == (i == 1) and any(nonzero) == (i == 1),
                        f"lora step {i + 1}: decoder b leaves non-zero {sum(nonzero)} of "
                        f"{len(nonzero)} (step 1's learning rate is 0)")
        require(all(math.isfinite(x) for x in losses), f"{mode}: losses {losses}")
        if mode != "full":
            require(all(torch.equal(a, b) for a, b in zip(snapshot, tree_leaves(base))),
                    f"{mode}: the base changed")
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
        stats[mode] = {"ms_per_step": 1e3 * sum(secs[1:]) / (len(secs) - 1),
                       "step_s": [round(s, 4) for s in secs], "peak_gib": peak,
                       "trainable": n_train, "losses": [round(x, 5) for x in losses]}
        log(f"train {mode}: {steps} steps, {n_train / 1e6:.2f} M trainable; losses "
            f"{stats[mode]['losses']}; s a step {stats[mode]['step_s']} (first a warm-up): "
            f"{stats[mode]['ms_per_step']:.1f} ms a step after it; peak device memory "
            f"{peak:.2f} GiB" + ("; the base bit-identical after the steps"
                                 if mode != "full" else ""))
        if mode == "lora":
            t = time.perf_counter()
            path = tr.save_checkpoint()
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            tr2 = Trainer(base, dit_cfg, tc, os.path.join(work, mode), seed=0, device=device)
            require(tr2.resume() and same_trainer_state(tr, tr2),
                    "the resumed LoRA trainer's state differs from the saved one")
            resume_s = time.perf_counter() - t
            t_d, noise = draw(torch.Generator(device=device).manual_seed(5), batch["latents"])
            a = tr.step_fn(tr.trainable, tr.opt_state, batch, t_d, noise)
            b = tr2.step_fn(tr2.trainable, tr2.opt_state, batch, t_d, noise)
            require(torch.equal(a[2], b[2]) and a[1].count == b[1].count and all(
                torch.equal(x, y) for x, y in zip(tree_leaves(a[0]) + tree_leaves(a[1].mu),
                                                  tree_leaves(b[0]) + tree_leaves(b[1].mu))),
                    "a step from the resumed state differs from a step from the saved state")
            log(f"LoRA checkpoint {os.path.basename(path)} ({save_s:.2f} s) resumed into a "
                f"fresh Trainer ({resume_s:.2f} s): trainable tree, moments, count and step "
                f"bit for bit; one more step from each with the same draws: bit-equal "
                f"(loss {float(a[2]):.6f})")
            del tr2, a, b               # tr2 holds the base too
        if mode == "full":
            base = tr.trainable
        del tr
    return base, stats


def train_card_vs_cpu(small_dit):
    """Phase train_check, part 1: 3 LoRA steps and 2 full steps of a small bf16
    DiT on the card and on the CPU with the same draws; the losses, the
    gradients at the start and the trained trees within TRAIN_REL (norm of the
    difference over the norm of the CPU's, per leaf)."""
    import torch

    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.training import flow_matching as fm
    from acestep_tpu_torch import weights
    from acestep_tpu_torch.training import lora as tlora
    from acestep_tpu_torch.weights import tree_to

    base = list_tree(RandomInit(torch.device("cpu"), 3, None), small_dit)
    lora0 = tlora.init_lora(torch.Generator().manual_seed(0), base, rank=8)
    gen = torch.Generator().manual_seed(6)
    batch0 = train_batch(small_dit, "cpu", frames=100, lc=40, masked=20)
    draws = [fm.draw(gen, batch0["latents"]) for _ in range(5)]
    runs = {}
    for d in ("cpu", "cuda"):
        batch = {k: v.to(d) for k, v in batch0.items()}
        p = tree_to(base, d)
        live = [x.detach().requires_grad_() for x in weights.tree_leaves(p)]
        t, noise = (x.to(d) for x in draws[0])
        loss = fm.flow_matching_loss(weights.tree_unflatten(p, live), small_dit, batch, t, noise)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        opt = fm.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
        step = tlora.make_lora_train_step(p, small_dit, opt, alpha=8.0)
        tree, state, losses = tree_to(lora0, d), None, []
        state = opt.init(tree)
        for i in range(3):
            tree, state, l = step(tree, state, batch, *(x.to(d) for x in draws[i]))
            losses.append(float(l))
        full = fm.make_train_step(small_dit, opt)
        ptree, pstate = p, opt.init(p)
        for i in range(3, 5):
            ptree, pstate, l = full(ptree, pstate, batch, *(x.to(d) for x in draws[i]))
            losses.append(float(l))
        runs[d] = (losses, [None if g is None else g.float().cpu() for g in grads],
                   [x.float().cpu() for x in weights.tree_leaves(tree)],
                   [x.float().cpu() for x in weights.tree_leaves(ptree)])

    def rel(a, b):
        if a is None or b is None:
            return 0.0 if a is b else float("inf")
        return float((a - b).norm() / b.norm().clamp(min=1e-30)) if b.norm() > 0 else \
            float(a.norm())

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    errs = {name: max(rel(a, b) for a, b in zip(runs["cuda"][i], runs["cpu"][i]))
            for i, name in ((1, "grads"), (2, "adapter"), (3, "full params"))}
    log(f"small DiT ({small_dit.hidden_size} x {small_dit.num_hidden_layers}) card vs CPU, "
        f"3 LoRA + 2 full steps, the same draws: losses card {runs['cuda'][0]}, CPU "
        f"{runs['cpu'][0]}; max relative loss difference {loss_rel:.3e}; per-leaf "
        f"|card - CPU| / |CPU| (norms): " + json.dumps({k: f"{v:.3e}" for k, v in errs.items()})
        + f" (bound {TRAIN_REL:g})")
    require(loss_rel <= TRAIN_REL and all(v <= TRAIN_REL for v in errs.values()),
            "small DiT training: the card disagrees with the CPU")


def res_backward_checks(vae_cfg, cases=None):
    """Phase train_check, part 2: rows 7 and 8 inside KernelGrad at the 10 s
    decode's shapes (or at ``cases``: ("unit" | "trio", (N, L, C), dilation
    or None)), gradients w.r.t. x and every weight against autograd
    through the plain version on the card (RES_TOL of each gradient's peak),
    and the forward that KernelGrad returns against the plain output (RES_TOL
    of the peak, and the kernels' own check_close bound).  Two planted faults
    must be rejected: the backward with the snake's sin^2 term dropped, and
    the single-pass TF32 kernel as KernelGrad's forward.  Returns (launches,
    shapes) of the checks."""
    import torch

    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    def no_sin_unit(x, w1, b1, w2, b2, a1, be1, a2, be2, d):
        s1 = x.transpose(1, 2)
        y1 = torch.nn.functional.conv1d(s1, w1.permute(2, 1, 0), b1, padding=3 * d,
                                        dilation=d)
        return x + (y1.transpose(1, 2) @ w2 + b2)

    def no_sin_trio(x, *stacked):
        for i, d in enumerate(vru.TRIO_D):
            x = no_sin_unit(x, *(t[i] for t in stacked), d)
        return x

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    if cases is None:
        up = vae_cfg.upsampling_ratios
        l256 = TRAIN_T * up[0] * up[1] * up[2]
        cases = [("unit", (1, l256, 256), d) for d in vru.TRIO_D]
        cases += [("trio", (1, l256 * up[3], 128), None),
                  ("trio", (1, l256 * up[3] * up[4], 128), None)]
    reset_counts()
    worst = 0.0
    for kind, (n, length, c), d in cases:
        units = ((_unit_params(c, 60),) if kind == "unit"
                 else tuple(_unit_params(c, 61 + j) for j in range(3)))
        x = _res_x(n, length, c, 62)
        leaves = [v for u in units for part in u.values() for v in part.values()]

        def grads(fn):
            ins = [x.clone().requires_grad_()] + [v.requires_grad_() for v in leaves]
            out = fn(ins[0])
            w = torch.linspace(-1.0, 1.0, out.numel(), device=out.device).reshape(out.shape)
            gs = torch.autograd.grad((out * w).sum(), ins)
            for v in leaves:
                v.requires_grad_(False)
            return out.detach(), gs

        def fwd_errs(out, ref_out):
            outside = float(((out - ref_out).abs()
                             / (RES_TOL + RES_TOL * ref_out.abs())).max())
            return rel(out, ref_out), outside

        if kind == "unit":
            tens = vru.unit_tensors(units[0])
            got = grads(lambda xx: vru.fused_res_unit(units[0], xx, d))
            ref = grads(lambda xx: vru.res_unit_plain(xx, *vru.unit_tensors(units[0]), d))
            ops = vru.unit_operands(units[0])
            faulty = grads(lambda xx: vru.KernelGrad.apply(
                lambda a: vru.launch_unit(a, ops, d),
                lambda a, *tt: no_sin_unit(a, *tt, d), xx, *vru.unit_tensors(units[0])))
            tf32 = grads(lambda xx: vru.KernelGrad.apply(
                lambda a: vru.launch_unit_tf32(a, ops, d),
                lambda a, *tt: vru.res_unit_plain(a, *tt, d), xx,
                *vru.unit_tensors(units[0])))
        else:
            def stacked():
                per = [vru.unit_tensors(u) for u in units]
                return tuple(torch.stack([p[i] for p in per]) for i in range(8))

            got = grads(lambda xx: vru.fused_res_trio(units, xx))
            ref = grads(lambda xx: vru.res_trio_plain(xx, *stacked()))
            ops = vru.trio_operands(units)
            faulty = grads(lambda xx: vru.KernelGrad.apply(
                lambda a: vru.launch_trio(a, ops), no_sin_trio, xx, *stacked()))
            tf32 = grads(lambda xx: vru.KernelGrad.apply(
                lambda a: vru.launch_trio_tf32(a, ops), vru.res_trio_plain, xx, *stacked()))
        errs = [rel(g, r) for g, r in zip(got[1], ref[1])]
        fault = max(rel(g, r) for g, r in zip(faulty[1], ref[1]))
        fwd_rel, fwd_out = fwd_errs(got[0], ref[0])
        tf32_rel, tf32_out = fwd_errs(tf32[0], ref[0])
        fwd_ok = fwd_rel <= RES_TOL and fwd_out <= 1
        tf32_caught = not (tf32_rel <= RES_TOL and tf32_out <= 1)
        worst = max(worst, max(errs), fwd_rel)
        log(f"  {kind} {(n, length, c)}{'' if d is None else f' d={d}'} forward: "
            f"{fwd_rel:.3e} of the peak, max err / check_close bound {fwd_out:.2f}; backward: "
            f"grad x {errs[0]:.3e}, weights max {max(errs[1:]):.3e} of the peak (bound "
            f"{RES_TOL:g}); planted faults: sin^2 dropped in the backward {fault:.3e} "
            f"{'rejected' if fault > RES_TOL else 'NOT rejected'}, single-pass TF32 forward "
            f"{tf32_rel:.3e} of the peak, max err / bound {tf32_out:.2f} "
            f"{'rejected' if tf32_caught else 'NOT rejected'}")
        require(fwd_ok, f"{kind}: KernelGrad's forward disagrees with the plain version")
        require(all(e <= RES_TOL for e in errs), f"{kind} backward disagrees with its plain "
                "version's autograd")
        require(fault > RES_TOL, f"{kind}: the planted backward fault was not rejected")
        require(tf32_caught, f"{kind}: the planted forward fault (TF32) was not rejected")
        del got, ref, faulty, tf32
        free_engine()
    counts = snapshot_counts()
    log(f"res kernels' backward check: worst {worst:.3e}; forward launches "
        + json.dumps({k: v for k, v in counts[0].items() if v}))
    return counts


def train_server(engine, dit_tree, train_tree, dit_cfg, work, device="cuda"):
    """Phase train_server: the REST server with both managers on 127.0.0.1
    port 0, phase full's engine.  /v1/dataset/build over two numpy-made WAVs,
    /v1/training/start (lora, 4 steps) on phase train's DiT saved as a
    checkpoint, the same job run directly for the server's overhead, and the
    exported adapter served through /v1/lora.  Returns {label: (launches,
    shapes)}."""
    import base64
    import dataclasses as dc

    import numpy as np

    from acestep_tpu_torch import loader
    from acestep_tpu_torch.lora_runtime import LoRARuntime
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.serving import launch
    from acestep_tpu_torch.serving.api_server import ApiServer
    from acestep_tpu_torch.serving.dataset_manager import DatasetManager
    from acestep_tpu_torch.serving.training_manager import (
        TrainingManager, default_trainer_factory)
    from acestep_tpu_torch.utils.audio import write_wav

    served, secs = {}, {}
    songs = os.path.join(work, "songs")
    os.makedirs(songs)
    rng = np.random.default_rng(4)
    for name, seconds in (("song_20s.wav", 20.0), ("song_30s.wav", 30.0)):
        wave = (rng.standard_normal((int(seconds * AUDIO_SR), 2)) * 0.1).astype(np.float32)
        write_wav(os.path.join(songs, name), wave, AUDIO_SR)
    with open(os.path.join(songs, "song_20s.txt"), "w") as f:
        f.write("bright synth pop with a driving beat")
    t = time.perf_counter()
    ckpt = os.path.join(work, "train_ckpt")
    os.makedirs(ckpt)
    loader.save_params(os.path.join(ckpt, "dit"), train_tree)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(dc.asdict(dit_cfg), f)
    secs["checkpoint save"] = time.perf_counter() - t
    base = dict(dit_tree, layers=unstack_layer_params(dit_tree["layers"]))
    srv = ApiServer(launch.make_generate_fn(engine), lora_runtime=LoRARuntime(engine, base),
                    training_manager=TrainingManager(device=device),
                    dataset_manager=DatasetManager(engine))
    port = srv.start("127.0.0.1", 0)
    try:
        code, scan = http(port, "/v1/dataset/scan", {"directory": songs})
        require(code == 200 and scan["count"] == 2, f"/v1/dataset/scan: {code} {scan}")
        ds = os.path.join(work, "dataset")
        reset_counts()
        t = time.perf_counter()
        code, out = http(port, "/v1/dataset/build", {"directory": songs, "output_dir": ds,
                                                     "auto_label": False})
        require(code == 200, f"/v1/dataset/build answered {code}: {out}")
        while True:
            code, st = http(port, "/v1/dataset/status")
            require(code == 200, f"/v1/dataset/status answered {code}")
            if st["state"] in ("completed", "failed"):
                break
            time.sleep(POLL_S)
        secs["dataset build"] = time.perf_counter() - t
        served["dataset build"] = snapshot_counts()
        require(st["state"] == "completed" and st["done"] == 2, f"dataset build: {st}")
        from acestep_tpu_torch.training.data import PreprocessedDataset

        pds = PreprocessedDataset(ds)
        frames = [pds.load(i)["latents"].shape[0] for i in range(2)]
        hop = engine.vae_cfg.hop_length
        require(frames == [int(20 * AUDIO_SR) // hop, int(30 * AUDIO_SR) // hop] and all(np.isfinite(pds.load(i)["latents"]).all()
                                             for i in range(2)), f"dataset frames {frames}")
        counts = served["dataset build"][0]
        require(counts[vru_names()[0]] > 0 and counts[vru_names()[1]] > 0,
                "the dataset build did not launch the res kernels")
        log(f"/v1/dataset/build of 2 WAVs (20 s, 30 s): {secs['dataset build']:.3f} s "
            f"({secs['dataset build'] / 2:.3f} s a sample, polled every {POLL_S} s); latents "
            f"{frames} frames; launches " + json.dumps({k: v for k, v in counts.items() if v}))

        payload = {"dataset_dir": ds, "checkpoint_dir": ckpt, "output_dir":
                   os.path.join(work, "job"), "mode": "lora", "lora_rank": LORA_RANK,
                   "lora_alpha": 16.0, "total_steps": 4, "batch_size": 1,
                   "checkpoint_every": 0, "lr": SERVER_TRAIN_LR}
        t = time.perf_counter()
        code, out = http(port, "/v1/training/start", payload)
        require(code == 200, f"/v1/training/start answered {code}: {out}")
        while True:
            code, st = http(port, "/v1/training/status")
            require(code == 200, f"/v1/training/status answered {code}")
            if st["state"] in ("completed", "failed", "stopped"):
                break
            time.sleep(POLL_S)
        secs["training job via HTTP"] = time.perf_counter() - t
        require(st["state"] == "completed" and st["step"] == 4 and st.get("export_path")
                and os.path.exists(st["export_path"] + ".safetensors"),
                f"training job: {st}")
        require(all(math.isfinite(x) for x in st["loss_history_tail"]), f"losses {st}")
        # the same job run directly: the server's overhead is the difference
        t = time.perf_counter()
        trainer, batches = default_trainer_factory(dict(payload, output_dir=os.path.join(
            work, "direct")), device=device)
        trainer.train(batches, max_steps=4, log_fn=lambda m: None)
        trainer.export("adapter")
        sync()
        secs["the same job direct"] = time.perf_counter() - t
        del trainer, batches
        log(f"/v1/training/start lora rank {LORA_RANK}, 4 steps at lr {SERVER_TRAIN_LR:g} on "
            f"phase train's DiT ({secs['checkpoint save']:.2f} s to save it): "
            f"{secs['training job via HTTP']:.3f} s through the server, "
            f"{secs['the same job direct']:.3f} s direct (checkpoint load, dataset, 4 steps, "
            f"export); losses {st['loss_history_tail']}; export {st['export_path']}")

        pay = {"caption": LM_CAPTION, "lyrics": LM_LYRICS, "duration": 10.0, "seed": 3}
        base_res = http_job(port, pay, "trained LoRA, base")[0]
        code, out = http(port, "/v1/lora", {"action": "register", "name": "trained",
                                            "path": st["export_path"], "alpha": 16.0})
        require(code == 200, f"/v1/lora register answered {code}: {out}")
        runs = {}
        for action in ("activate", "deactivate"):
            sync()
            t = time.perf_counter()
            code, out = http(port, "/v1/lora", {"action": action, "name": "trained"})
            secs[f"LoRA {action}"] = time.perf_counter() - t
            require(code == 200, f"/v1/lora {action} answered {code}: {out}")
            runs[action], _, _, served[f"trained LoRA {action}"] = http_job(
                port, pay, f"trained LoRA {action}")
        a0, a1, a2 = (base64.b64decode(r["audio_base64"])
                      for r in (base_res, runs["activate"], runs["deactivate"]))
        require(a1 != a0, "the trained adapter left the audio as it was")
        require(a2 == a0, "deactivating the trained adapter did not restore the base's int16")
        log(f"the trained adapter through /v1/lora: activate {secs['LoRA activate']:.3f} s "
            f"(merge into the q4_k kernels, requantized), the audio moved; deactivate "
            f"{secs['LoRA deactivate']:.3f} s restored the base's int16 bit for bit")
    finally:
        srv.stop()
    log("train_server seconds: " + json.dumps({k: round(v, 4) for k, v in secs.items()}))
    return served, secs


# ---------------------------------------------------------------------------
# the quantization-quality tools (phase quality)
# ---------------------------------------------------------------------------

def counted(label, fn):
    """``fn()`` with the counts reset just before and read just after:
    (its result, (launches, shapes), seconds)."""
    reset_counts()
    t = time.perf_counter()
    out = fn()
    sync()
    secs = time.perf_counter() - t
    counts = snapshot_counts()
    log(f"{label}: {secs:.1f} s; launches "
        + json.dumps({k: v for k, v in counts[0].items() if v}))
    return out, counts, secs


def add_counts(total, counts):
    for name, n in counts[0].items():
        total[name] = total.get(name, 0) + n


def variant_counts(total):
    """(counts by variant, the ``on_variant`` callback of the quality tools
    that fills it): each variant's (launches, shapes) since the last reset,
    also added to ``total``; the counts are reset after each."""
    per = {}

    def on_variant(name):
        per[name] = snapshot_counts()
        add_counts(total, per[name])
        reset_counts()

    return per, on_variant


def check_quality_rows(label, rows, need):
    """Every quant row finite; each variant launched its format's kernel
    (``need``: variant -> kernel names that must have launched)."""
    for r in rows:
        m = r.get("metrics")
        require(m is None or all(math.isfinite(v) for v in m.values()),
                f"{label} {r['variant']}: non-finite metrics {m}")
    for variant, (launches, _), kernels in need:
        require(all(launches[k] > 0 for k in kernels),
                f"{label} {variant}: a kernel of the variant was not launched (need {kernels})")


def quality_eval_full(names, unit, trio, work, smi_line, total, recheck):
    """Phase quality (a): eval_quant_pipeline at full width."""
    from acestep_tpu_torch import eval_quant_pipeline as eqp

    per, on_variant = variant_counts(total)
    log(f"(a) eval_quant_pipeline, full width, 10 s, on {smi_line}")
    reset_counts()
    t = time.perf_counter()
    rows = eqp.evaluate(os.path.join(work, "quant_eval"), device="cuda", log=log,
                        on_variant=on_variant)
    secs = time.perf_counter() - t
    for variant, counts in per.items():
        log(f"  {variant}: launches in its two requests "
            + json.dumps({k: v for k, v in counts[0].items() if v}))
    check_quality_rows("(a)", rows, [
        (v, per[v], [unit, trio] + ([names[v]] if v in names else []))
        for v in ("fp_bf16", *eqp.FORMATS)])
    require(per["fp_bf16"][0][names["q8_0"]] == 0, "(a) the bf16 engine launched q8_0")
    q8 = next(r for r in rows if r["variant"] == "q8_0")["metrics"]
    require(q8["latent_cos"] > 0.99, f"(a) q8_0 latent cosine {q8['latent_cos']}")
    for i, (variant, counts) in enumerate(per.items()):
        recheck(counts[1], 80 + i)
    log(f"(a) took {secs:.1f} s: " + json.dumps(
        {r["variant"]: {"infer_s": round(r["infer_s"], 4), **(
            {k: round(v, 6) for k, v in r["metrics"].items()} if r["metrics"] else {})}
         for r in rows}))


def half_encoder_cases(vae_cfg, batch):
    """The res-kernel shapes of the half-scale encoder on a crop batch:
    blocks 0-1 (128 channels) on the trio, block 2 (256) unit by unit."""
    from acestep_tpu_torch import train_quality_eval as tqe
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    cm = (1,) + tuple(vae_cfg.channel_multiples)
    cases, length = [], tqe.CROP
    for i, s in enumerate(vae_cfg.downsampling_ratios):
        c = vae_cfg.encoder_hidden_size * cm[i]
        if c in vru.TRIO_CHANNELS:
            cases.append(("trio", (batch, length, c), None))
        elif c in vru.UNIT_CHANNELS:
            cases += [("unit", (batch, length, c), d) for d in vru.TRIO_D]
        length //= s
    return cases


def quality_train(names, unit, trio, work, total, recheck):
    """Phase quality (b): train_quality_eval on the reduced schedule."""
    from acestep_tpu_torch import train_quality_eval as tqe

    out = os.path.join(work, "train_quality")
    vae_cfg = tqe.configs()[1]
    meta, c_vae, s_vae = counted(
        f"(b) phase vae, {QUALITY_VAE_STEPS} steps at batch {QUALITY_VAE_BATCH} over "
        f"{QUALITY_SONGS} songs",
        lambda: tqe.phase_vae(out, QUALITY_VAE_STEPS, QUALITY_VAE_BATCH,
                              n_songs=QUALITY_SONGS, device="cuda", log=log))
    require(all(math.isfinite(r["loss"]) for r in meta["losses"]),
            f"(b) VAE losses {meta['losses']}")
    cases = half_encoder_cases(vae_cfg, QUALITY_VAE_BATCH)
    for kind, (n, length, c), d in cases:
        name = unit if kind == "unit" else trio
        shape = (n, length, c) + ((d,) if kind == "unit" else ())
        require(c_vae[1][name].get(shape, 0) == QUALITY_VAE_STEPS,
                f"(b) {name} {shape} launched {c_vae[1][name].get(shape, 0)} times in the "
                f"VAE steps, {QUALITY_VAE_STEPS} expected (one a step, inside KernelGrad)")
    log(f"(b) a VAE step launches {c_vae[0][unit] // QUALITY_VAE_STEPS} + "
        f"{c_vae[0][trio] // QUALITY_VAE_STEPS} (unit + trio, forward inside KernelGrad; the "
        f"held-out recon adds {c_vae[0][unit] % QUALITY_VAE_STEPS} + "
        f"{c_vae[0][trio] % QUALITY_VAE_STEPS}); {s_vae / QUALITY_VAE_STEPS * 1e3:.1f} ms a "
        f"step with the reads; held-out spectral L1 {meta['spectral_recon_logmag_l1']:.4f}")
    _, c_data, _ = counted("(b) phase data", lambda: tqe.phase_data(
        out, n_songs=QUALITY_SONGS, device="cuda", log=log))
    train, c_train, s_train = counted(
        f"(b) phase train, {QUALITY_DIT_STEPS} steps at batch {QUALITY_DIT_BATCH}",
        lambda: tqe.phase_train(out, QUALITY_DIT_STEPS, QUALITY_DIT_BATCH, device="cuda",
                                log=log))
    require(train["steps"] == QUALITY_DIT_STEPS
            and all(math.isfinite(x) for x in train["history"]),
            f"(b) DiT training: {train['steps']} steps, losses {train['history']}")
    per, on_variant = variant_counts(total)
    reset_counts()
    t = time.perf_counter()
    summary = tqe.phase_eval(out, os.path.join(out, "report"), device="cuda", log=log,
                             on_variant=on_variant)
    s_eval = time.perf_counter() - t
    for variant, counts in per.items():
        log(f"  (b) eval {variant}: launches in its two requests "
            + json.dumps({k: v for k, v in counts[0].items() if v}))
    check_quality_rows("(b)", summary["rows"], [
        (v, per[v], [names[v]] if v in names else []) for v in ("fp_bf16", *tqe.EVAL_FORMATS)])
    require(summary["vae_trained"] and len(summary["decoder_control"]) == 2,
            "(b) the eval did not run the decoder-leg control on the trained VAE")
    for counts in (c_vae, c_data, c_train):
        add_counts(total, counts)
    for i, counts in enumerate([c_vae, c_data] + list(per.values())):
        recheck(counts[1], 90 + i)
    log(f"(b) eval {s_eval:.1f} s; train {s_train:.1f} s "
        f"({s_train / QUALITY_DIT_STEPS * 1e3:.1f} ms a step with the data reads)")
    add_counts(total, res_backward_checks(vae_cfg, cases))


@contextlib.contextmanager
def res_units_as_plain_convs():
    """The VAE's res units as plain torch convs on every device (the channel
    counts the kernels take emptied), for the plain path's drift."""
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    saved = vru.UNIT_CHANNELS, vru.TRIO_CHANNELS
    vru.UNIT_CHANNELS, vru.TRIO_CHANNELS = (), ()
    try:
        yield
    finally:
        vru.UNIT_CHANNELS, vru.TRIO_CHANNELS = saved


def vae_card_vs_cpu(total):
    """Phase quality (c): the half-scale VAE's loss and gradients at its
    initial tree on one crop batch, on the card (rows 7-8 in KernelGrad)
    against the CPU (their plain versions), within VAE_DRIFT_FACTOR x the
    drift of the card's plain path (res units as plain convs) against the
    CPU, never tighter than the floors; then QUALITY_CMP_STEPS steps on each
    path from there, whose divergence is logged: the loss at init is steep
    (the latent-scale term is a square of the encoder's mean square gain), so
    Adam's +-lr moves of the elements whose gradients nearly cancel part
    any two paths within a few steps, the plain one too."""
    import numpy as np
    import torch

    from acestep_tpu_torch import train_quality_eval as tqe
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.weights import tree_leaves, tree_to

    vae_cfg = tqe.configs()[1]
    p0 = RandomInit(torch.device("cpu"), tqe.VAE_SEED, None).vae(vae_cfg)
    rng = np.random.default_rng(5)
    songs = np.stack([tqe.synth_song(rng) for _ in range(QUALITY_SONGS)])
    batches = [tqe.crops(rng, songs, QUALITY_CMP_BATCH) for _ in range(QUALITY_CMP_STEPS)]
    opt = tqe.vae_optimizer(QUALITY_CMP_STEPS)

    def grads(d):
        loss, _, got = tqe.vae_grads(tree_to(p0, d), vae_cfg, torch.from_numpy(batches[0]).to(d))
        return float(loss), [g.cpu() for g in got]

    def steps(d):
        params = tree_to(p0, d)
        state, losses = opt.init(params), []
        for b in batches:
            params, state, loss, _ = tqe.vae_step(params, state, opt, vae_cfg,
                                                  torch.from_numpy(b).to(d))
            losses.append(float(loss))
        return losses, [x.float().cpu() for x in tree_leaves(params)]

    def rel(a, b):
        if float(b.norm()) == 0.0:
            return 0.0 if float(a.norm()) == 0.0 else float("inf")
        return float((a - b).norm() / b.norm())

    cpu_g, cpu_s = grads("cpu"), steps("cpu")
    with res_units_as_plain_convs():
        plain_g, plain_s = grads("cuda"), steps("cuda")
    (kern_g, kern_s), counts, _ = counted("(c) the VAE's gradients and steps on the card "
                                             "(kernels)", lambda: (grads("cuda"), steps("cuda")))
    add_counts(total, counts)
    start = [x.float() for x in tree_leaves(p0)]

    def drift(g, s):
        return (abs(g[0] - cpu_g[0]) / abs(cpu_g[0]), max(rel(a, b) for a, b in zip(g[1], cpu_g[1])),
                max(abs(x - y) / abs(y) for x, y in zip(s[0], cpu_s[0])),
                max(rel(p - q0, q - q0) for p, q, q0 in zip(s[1], cpu_s[1], start)))

    d_plain, d_kern = drift(plain_g, plain_s), drift(kern_g, kern_s)
    bound = (max(VAE_DRIFT_FACTOR * d_plain[0], VAE_LOSS_FLOOR),
             max(VAE_DRIFT_FACTOR * d_plain[1], VAE_GRAD_FLOOR))
    log(f"(c) half-scale VAE at batch {QUALITY_CMP_BATCH}, card vs CPU at the initial tree: "
        f"loss {kern_g[0]:.6f} / CPU {cpu_g[0]:.6f}; relative loss difference and max "
        f"per-leaf gradient |card - CPU| / |CPU| (norms): plain path on the card "
        f"{d_plain[0]:.3e} / {d_plain[1]:.3e}, kernel path {d_kern[0]:.3e} / "
        f"{d_kern[1]:.3e} (bounds {bound[0]:.3e} / {bound[1]:.3e}: {VAE_DRIFT_FACTOR}x the "
        f"plain path's, floors {VAE_LOSS_FLOOR:g} / {VAE_GRAD_FLOOR:g})")
    log(f"(c) then {QUALITY_CMP_STEPS} steps (not held: see the docstring): losses card "
        f"{kern_s[0]}, plain path {plain_s[0]}, CPU {cpu_s[0]}; max relative loss "
        f"difference / max per-leaf |update - CPU's| / |CPU's update|: plain path "
        f"{d_plain[2]:.3e} / {d_plain[3]:.3e}, kernel path {d_kern[2]:.3e} / {d_kern[3]:.3e}")
    unit, trio = vru_names()
    require(counts[0][unit] > 0 and counts[0][trio] > 0,
            "(c) the card's VAE steps launched no res kernel")
    require(all(math.isfinite(x) for x in kern_s[0]), f"(c) VAE losses {kern_s[0]}")
    require(d_kern[0] <= bound[0] and d_kern[1] <= bound[1],
            "(c) the VAE's loss or gradients on the card disagree with the CPU's")


def quality_ablation(names, work, total, recheck):
    """Phase quality (d): ablate_quant_noise's parts A-C on the card."""
    from acestep_tpu_torch import ablate_quant_noise as aqn

    res, counts, _ = counted("(d) ablate_quant_noise", lambda: aqn.run(
        os.path.join(work, "quant_ablation"), device="cuda"))
    add_counts(total, counts)
    require(counts[0][names["q8_0"]] > 0, "(d) the ablation launched no q8_0 kernel")
    require(res["ok_a"], f"(d) format-level matmul cosine at most 0.999: {res['a']}")
    require(all(math.isfinite(c) for _, c in res["b"] + res["c"]), "(d) non-finite cosine")
    recheck(counts[1], 120)
    log(f"(d) depth-monotonic decay (a finding, not a gate): {res['decays']}")


def quality_phase(names, unit, trio, smi_line, recheck):
    """Phase quality: (a)-(d); returns the launches by kernel name."""
    import shutil

    work = os.path.join("build", "quality")
    shutil.rmtree(work, ignore_errors=True)
    total = {}
    t = time.perf_counter()
    quality_eval_full(names, unit, trio, work, smi_line, total, recheck)
    free_engine()
    quality_train(names, unit, trio, work, total, recheck)
    free_engine()
    vae_card_vs_cpu(total)
    quality_ablation(names, work, total, recheck)
    free_engine()
    log(f"phase quality: {time.perf_counter() - t:.1f} s; launches "
        + json.dumps({k: v for k, v in total.items() if v}))
    return total


def phase_alone(tool: str):
    """The set-up of one phase run alone (tools/quality_phase.py,
    tools/planners_phase.py): prints the card's nvidia-smi line, turns TF32
    off and builds the kernels.  Returns (that line, a ``recheck(shapes,
    seed)`` that holds every dequant-matmul, res-unit and trio shape to its
    plain version once, as phase check does), or None without a card."""
    import torch
    from acestep_tpu_torch.ops.cuda import _build, qmm

    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device", file=sys.stderr)
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    unit, trio = vru_names()
    checked = {name: set() for name in list(names.values()) + [unit, trio]}

    def recheck(shapes, seed):
        for fmt, name in names.items():
            for shape in set(shapes[name]) - checked[name]:
                check_qmm(fmt, shape, seed)
                checked[name].add(shape)
        for name, check in ((unit, check_unit), (trio, check_trio)):
            for shape in set(shapes[name]) - checked[name]:
                check(shape, seed)
                checked[name].add(shape)

    return smi, recheck


def vru_names():
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    return vru.UNIT.name, vru.TRIO.name


def cli_run(work):
    """Phase cli: the port's CLI in a subprocess on the card."""
    import numpy as np

    from acestep_tpu_torch.utils.audio import read_wav

    out = os.path.join(work, "cli.wav")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "acestep_tpu_torch.cli",
                           "--pipeline-style-lyric", "--audio-seconds", "10", "--out", out],
                          capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t
    require(proc.returncode == 0, f"the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    audio, sr = read_wav(out)
    require(info["mode"] == "pipeline" and info["samples"] == 480000
            and audio.shape == (480000, 2) and sr == AUDIO_SR and np.abs(audio).max() > 0,
            f"CLI: {info}, WAV {audio.shape} at {sr}")
    log(f"python -m acestep_tpu_torch.cli --pipeline-style-lyric --audio-seconds 10: rc 0 in "
        f"{wall:.1f} s (process start, full-width q8_0 engine drawn on the card, one "
        f"request); WAV {audio.shape[0]} frames at {sr} Hz; JSON line " + json.dumps(info)
        + "; stderr: " + proc.stderr.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the checkpoint converter
# ---------------------------------------------------------------------------

def _host(t):
    """A tensor on the host as numpy, bf16 as its raw bits (uint16)."""
    import torch

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view("<u2")
    return t.cpu().numpy()


class RefWriter:
    """Tensors under the reference's names and torch layouts: the reference
    importers' transforms (acestep_tpu_torch/loader.py) inverted."""

    def __init__(self):
        self.tensors, self.dtype_map = {}, {}

    def put(self, name, t):
        import torch

        self.tensors[name] = _host(t)
        if t.dtype == torch.bfloat16:
            self.dtype_map[name] = "BF16"

    def lin(self, name, p):                 # kernel [in, out] -> weight [out, in]
        self.put(name + ".weight", p["kernel"].t())
        if "bias" in p:
            self.put(name + ".bias", p["bias"])

    def attn(self, pre, p):
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.lin(pre + n, p[n])
        self.put(pre + "q_norm.weight", p["q_norm"])
        self.put(pre + "k_norm.weight", p["k_norm"])

    def mlp(self, pre, p):
        for n in ("gate_proj", "up_proj", "down_proj"):
            self.lin(pre + n, p[n])

    def block(self, pre, p):
        """A pre-norm transformer layer: the DiT's encoder layers nest their
        attention and MLP (``self_attn`` / ``mlp``), Qwen3's keep them flat."""
        self.put(pre + "input_layernorm.weight", p["input_norm"])
        self.attn(pre + "self_attn.", p.get("self_attn", p))
        self.put(pre + "post_attention_layernorm.weight", p["post_norm"])
        self.mlp(pre + "mlp.", p.get("mlp", p))

    def conv(self, name, p, transposed=False, with_bias=True):
        """[k, in, out] -> torch [out, in, k] (a transposed conv: reversed taps,
        [in, out, k]) as weight_v plus weight_g = ||v|| over dims 1-2 of each
        dim-0 slice (f64, rounded to f32), as the published Oobleck ships them."""
        import numpy as np

        w = p["w"]
        v = _host(w.flip(0).permute(1, 2, 0) if transposed else w.permute(2, 1, 0))
        g = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True))
        self.tensors[name + ".weight_v"] = v
        self.tensors[name + ".weight_g"] = g.astype(np.float32)
        if with_bias and "b" in p:
            self.put(name + ".bias", p["b"])

    def snake(self, name, p):
        self.put(name + ".alpha", p["alpha"].reshape(1, -1, 1))
        self.put(name + ".beta", p["beta"].reshape(1, -1, 1))

    def res(self, name, p):
        self.snake(name + ".snake1", p["snake1"])
        self.conv(name + ".conv1", p["conv1"])
        self.snake(name + ".snake2", p["snake2"])
        self.conv(name + ".conv2", p["conv2"])

    def write(self, directory, cfg):
        from acestep_tpu_torch.utils.safetensors_io import save_safetensors

        os.makedirs(directory)
        path = os.path.join(directory, "model.safetensors")
        save_safetensors(path, self.tensors, None, self.dtype_map)
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        return os.path.getsize(path)


def dit_reference(tree, cfg) -> RefWriter:
    """The DiT (per-layer lists) under the reference's ``decoder.*`` /
    ``encoder.*`` names: patchify conv [H, C, p], unpatchify conv [H, A, p]."""
    w, h, ps = RefWriter(), cfg.hidden_size, cfg.patch_size
    w.put("decoder.proj_in.1.weight",
          tree["proj_in"]["kernel"].reshape(ps, cfg.in_channels, h).permute(2, 1, 0))
    w.put("decoder.proj_in.1.bias", tree["proj_in"]["bias"])
    w.put("decoder.proj_out.1.weight", tree["proj_out"]["kernel"].reshape(
        h, ps, cfg.audio_acoustic_hidden_dim).permute(0, 2, 1))
    w.put("decoder.proj_out.1.bias", tree["proj_out"]["bias"])
    for te in ("time_embed", "time_embed_r"):
        for n in ("linear_1", "linear_2", "time_proj"):
            w.lin(f"decoder.{te}.{n}", tree[te][n])
    w.lin("decoder.condition_embedder", tree["condition_embedder"])
    w.put("decoder.norm_out.weight", tree["norm_out"])
    w.put("decoder.scale_shift_table", tree["out_scale_shift_table"].reshape(1, 2, h))
    for i, layer in enumerate(tree["layers"]):
        p = f"decoder.layers.{i}."
        for n in ("self_attn", "cross_attn"):
            w.put(p + n + "_norm.weight", layer[n + "_norm"])
            w.attn(p + n + ".", layer[n])
        w.put(p + "mlp_norm.weight", layer["mlp_norm"])
        w.mlp(p + "mlp.", layer["mlp"])
        w.put(p + "scale_shift_table", layer["scale_shift_table"].reshape(1, 6, h))
    w.lin("encoder.text_projector", tree["text_projector"])
    for enc in ("lyric", "timbre"):
        w.lin(f"encoder.{enc}_encoder.embed_tokens", tree[f"{enc}_embed"])
        for i, layer in enumerate(tree[f"{enc}_layers"]):
            w.block(f"encoder.{enc}_encoder.layers.{i}.", layer)
        w.put(f"encoder.{enc}_encoder.norm.weight", tree[f"{enc}_norm"])
    w.put("encoder.timbre_encoder.special_token", tree["timbre_special_token"].reshape(1, 1, h))
    return w


def qwen_reference(tree) -> RefWriter:
    """A Qwen3 stack (per-layer list) under the HF names (tied embeddings)."""
    w = RefWriter()
    w.put("model.embed_tokens.weight", tree["embed_tokens"])
    for i, layer in enumerate(tree["layers"]):
        w.block(f"model.layers.{i}.", layer)
    w.put("model.norm.weight", tree["norm"])
    return w


def vae_reference(tree, cfg) -> RefWriter:
    """The Oobleck VAE under the diffusers names, every conv weight-normed."""
    w = RefWriter()
    enc, dec = tree["encoder"], tree["decoder"]
    w.conv("encoder.conv1", enc["conv1"])
    for i, b in enumerate(enc["blocks"]):
        p = f"encoder.block.{i}"
        for j in (1, 2, 3):
            w.res(f"{p}.res_unit{j}", b[f"res{j}"])
        w.snake(p + ".snake1", b["snake1"])
        w.conv(p + ".conv1", b["conv1"])
    w.snake("encoder.snake1", enc["snake1"])
    w.conv("encoder.conv2", enc["conv2"])
    w.conv("decoder.conv1", dec["conv1"])
    for i, b in enumerate(dec["blocks"]):
        p = f"decoder.block.{i}"
        w.snake(p + ".snake1", b["snake1"])
        w.conv(p + ".conv_t1", b["conv_t1"], transposed=True)
        for j in (1, 2, 3):
            w.res(f"{p}.res_unit{j}", b[f"res{j}"])
    w.snake("decoder.snake1", dec["snake1"])
    w.conv("decoder.conv2", dec["conv2"], with_bias=False)
    return w


def tree_mismatches(got, want):
    """Leaf names where ``got`` is not ``want`` bit for bit (dtype, format,
    every field), and names only one tree has."""
    import torch

    from acestep_tpu_torch.quant import QuantTensor
    from acestep_tpu_torch.weights import flatten

    g, w = flatten(got), flatten(want)
    bad = sorted(set(g) ^ set(w))
    for name in sorted(set(g) & set(w)):
        a, b = g[name], w[name]
        if isinstance(b, QuantTensor):
            fa, fb = (a.fields() if isinstance(a, QuantTensor) and a.fmt == b.fmt else {},
                      b.fields())
            ok = fa.keys() == fb.keys() and all(
                fa[f].dtype == t.dtype and torch.equal(fa[f], t.to(fa[f].device))
                for f, t in fb.items())
        else:
            ok = (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                  and torch.equal(a, b.to(a.device)))
        if not ok:
            bad.append(name)
    return bad


def vae_gap(got, want):
    """(largest f32 ulp distance, largest relative gap) between the converted
    VAE's conv weights and the drawn ones; every other leaf must be equal."""
    import torch

    from acestep_tpu_torch.weights import flatten

    g, w = flatten(got), flatten(want)
    require(g.keys() == w.keys(), f"VAE leaves differ: {sorted(set(g) ^ set(w))[:6]}")
    ulps, rel = 0, 0.0
    for name, b in w.items():
        a = g[name].to(b.device)
        if not name.endswith("/w"):
            require(torch.equal(a, b), f"VAE leaf {name} changed in the conversion")
            continue
        require(bool((torch.sign(a) == torch.sign(b)).all()), f"VAE {name}: a sign changed")
        ulps = max(ulps, int((a.view(torch.int32).long() - b.view(torch.int32).long())
                             .abs().max()))
        rel = max(rel, float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()))
    return ulps, rel


def convert_phase(dit_cfg, vae_cfg, text_cfg, style, lyric, need, dev="cuda"):
    """Phase convert: full-width weights drawn on the card (``dev``), written
    in the reference's layout, converted on the host, and served through
    build_engine against an engine of the same weights quantized in memory on
    the card.  Returns the request's (launches, shapes)."""
    import io
    import shutil

    import numpy as np
    import torch

    from acestep_tpu_torch import convert_checkpoint, loader, pipeline, roofline
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.quant.convert import importer_policy, quantize_tree
    from acestep_tpu_torch.serving import launch
    from acestep_tpu_torch.weights import flatten

    work = tempfile.TemporaryDirectory(prefix="acestep_convert_")
    free = shutil.disk_usage(work.name).free
    log(f"free disk under {work.name}: {free / 2**30:.1f} GiB")
    t = time.perf_counter()
    init = RandomInit(torch.device(dev), seed=21, quant=None)
    dit_tree = list_tree(init, dit_cfg)
    text_tree = init.qwen(text_cfg)
    text_tree["layers"] = unstack_layer_params(text_tree["layers"])
    vae_tree = init.vae(vae_cfg)
    sync()
    counts = {k: sum(x.numel() for x in flatten(v).values())
              for k, v in (("dit", dit_tree), ("text_encoder", text_tree), ("vae", vae_tree))}
    log(f"drawn on the card in {time.perf_counter() - t:.1f} s: bf16 DiT {counts['dit']:,}, "
        f"bf16 text encoder {counts['text_encoder']:,}, f32 VAE {counts['vae']:,} parameters")

    ref = os.path.join(work.name, "reference")
    srcs, t = {}, time.perf_counter()
    for name, writer, cfg in (("dit", dit_reference(dit_tree, dit_cfg), dit_cfg),
                              ("text_encoder", qwen_reference(text_tree), text_cfg),
                              ("vae", vae_reference(vae_tree, vae_cfg), vae_cfg)):
        srcs[name] = os.path.join(ref, name)
        size = writer.write(srcs[name], cfg)
        log(f"  {name}: {len(writer.tensors)} reference tensors, {size / 2**30:.3f} GiB")
        del writer
    log(f"reference-layout checkpoints written in {time.perf_counter() - t:.1f} s")

    out = os.path.join(work.name, "converted")
    argv = ["--dit", srcs["dit"], "--vae", srcs["vae"], "--text", srcs["text_encoder"],
            "--out", out, "--quant", "q4_k"]
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = convert_checkpoint.main(argv)
    wall = time.perf_counter() - t
    require(rc == 0, f"convert_checkpoint exited {rc}")
    shutil.rmtree(ref)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    sizes = {n: os.path.getsize(os.path.join(out, n)) for n in sorted(os.listdir(out))}
    log(f"converted on the host (native quantizers) in {wall:.3f} s; per component (s): "
        + json.dumps({k: v["seconds"] for k, v in manifest["components"].items()})
        + f"; {sum(sizes.values()) / 2**30:.3f} GiB written: " + json.dumps(sizes))

    t = time.perf_counter()
    engine, loaded_dit = launch.build_engine(out, device=dev)
    sync()
    log(f"build_engine of the converted directory on the card in {time.perf_counter() - t:.1f} s")
    loaded_text = loader.load_params(os.path.join(out, "text_encoder"), device=dev)
    loaded_vae = loader.load_params(os.path.join(out, "vae"), device=dev)
    work.cleanup()
    want_dit = quantize_tree(dit_tree, "q4_k", importer_policy)
    want_text = quantize_tree(text_tree, "q4_k", importer_policy)
    for what, got, want in (("DiT", loaded_dit, want_dit), ("text encoder", loaded_text,
                                                           want_text)):
        bad = tree_mismatches(got, want)
        require(not bad, f"converted {what} leaves differ from quantize_tree's: {bad[:6]}")
        fmts = sorted({leaf.fmt for leaf in flatten(got).values() if hasattr(leaf, "fmt")})
        log(f"converted {what}: every leaf equal bit for bit to the drawn tree quantized in "
            f"memory on the card (quant.convert.quantize_tree); formats {fmts}")
    ulps, rel = vae_gap(loaded_vae, vae_tree)
    log(f"converted VAE (weight norm folded in f64): conv weights within {ulps} f32 ulps of "
        f"the drawn ones, largest relative gap {rel:.3e}; every other leaf equal")
    require(ulps <= 4, f"the VAE fold moved a weight by {ulps} ulps")
    del loaded_dit, loaded_text, loaded_vae, dit_tree, text_tree

    mem_engine = pipeline.AceStepEngine(want_dit, dit_cfg, vae_tree, vae_cfg, want_text,
                                        text_cfg, device=dev)
    del want_dit, want_text
    frames = pipeline.bucket_frames(pipeline.frames_for_duration(60.0))
    noise = torch.randn((1, frames, dit_cfg.audio_acoustic_hidden_dim),
                        generator=torch.Generator(device=dev).manual_seed(22), device=dev)
    req = pipeline.GenerationRequest(duration_s=60.0, style_token_ids=style,
                                     lyric_token_ids=lyric, seeds=[1])
    reset_counts()
    res = engine.generate(req, noise=noise)
    served = snapshot_counts()
    log("converted engine, 60 s q4_k request: time_costs "
        + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
    log("converted engine, 60 s q4_k request launches: "
        + json.dumps({k: v for k, v in served[0].items() if v}))
    require(all(served[0][n] > 0 for n in need),
            f"the converted engine's request missed a kernel of {need}")
    ref_res = mem_engine.generate(req, noise=noise)
    check_audio([res, ref_res], 1500 * vae_cfg.hop_length)
    same = np.array_equal(res.latents, ref_res.latents)
    log(f"latents of the converted engine and of the in-memory one: "
        f"{'equal bit for bit' if same else 'DIFFERENT'}")
    require(same, "the converted engine's latents differ from the in-memory engine's")
    cos, snr = gate(ref_res.audio_i16, res.audio_i16)
    log(f"int16 audio, converted vs in-memory engine (eval_metrics): cosine {cos:.9f} "
        f"(>= 0.999), SNR {snr:.2f} dB (>= 26)")
    require(cos >= 0.999 and snr >= 26.0, "the converted engine's audio misses the Q8_0 gate")

    chip = roofline.detect_chip()
    step_s = res.time_costs["diffusion_per_step_time_cost"]
    point = roofline.RooflinePoint(
        phase="DiT step, 60 s q4_k, converted engine", time_s=step_s,
        bytes_=roofline.dit_step_weight_bytes(engine.dit_params),
        flops=roofline.dit_step_flops(dit_cfg, frames, style.shape[1] + lyric.shape[1]),
        chip=chip)
    print("roofline " + json.dumps({**point.summary(), "weight_bytes": point.bytes_,
                                    "flops": point.flops}), flush=True)
    del engine, mem_engine
    free_engine()
    return served


# ---------------------------------------------------------------------------
# phase planners: the 1.7B and 4B LM planners from a checkpoint
# ---------------------------------------------------------------------------

PLANNER_CODES_S = 10.0          # the 4B's codes phases: 50 codes (code bucket 64)
PLANNER_CODES = 50
PLANNER_CANDIDATES = 2          # the 1.7B song's candidates, ranked by PMI
PLANNER_LOGIT_STEPS = 16        # decode steps whose logits each kernel path is held on
PLANNER_INT8_BATCH = 16         # the 4B's int8_act codes phase: every linear at M 16
PLANNER_ATTN = ("auto", "pallas", "fused")


def demo_tokenizer_json(path, size):
    """Write ``path``: the demo vocabulary (:func:`build_demo_vocab`) as a
    WordLevel tokenizer.json for ``lm_pipeline.TokenizerJsonAdapter`` (the
    ``tokenizers`` package).  ByteTokenizer's code range holds
    ``<|audio_code_j|>`` and its EOS id ``<|im_end|>``; ``</think>`` (id 1)
    and ``<|im_end|>`` tokenize whole; a word outside the vocabulary is id 0.
    Returns the pieces by id."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    pieces = build_demo_vocab(size)
    base, eos = ByteTokenizer.audio_code_base_id, ByteTokenizer.eos_token_id
    pieces[base:eos] = [f"<|audio_code_{j}|>" for j in range(eos - base)]
    pieces[eos] = "<|im_end|>"
    tok = Tokenizer(models.WordLevel({p: i for i, p in enumerate(pieces)}, unk_token=pieces[0]))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["</think>", "<|im_end|>"])
    tok.save(path)
    return pieces


@contextlib.contextmanager
def plain_int8():
    """Row 6's plain version for CUDA tensors too, inside the block."""
    from acestep_tpu_torch.ops.cuda import qmm_int8

    real = qmm_int8.qmm_int8_act

    def plain(x, qt, li=None):
        return qmm_int8.qmm_int8_act_plain(x, qt if li is None else qt.layer(li))

    qmm_int8.qmm_int8_act = plain
    try:
        yield
    finally:
        qmm_int8.qmm_int8_act = real


def planner_logits(params, cfg, ids, decode_attn, int8_act, forced=None,
                   steps=PLANNER_LOGIT_STEPS, dev="cuda"):
    """Logits (f32, on the host) of a batch-1 prefill of ``ids`` (padded to
    its prompt bucket) and ``steps`` greedy decode steps on the card; the
    decode megakernel declines these widths, so every step is the layer scan.
    ``forced`` (another run's logits) supplies the tokens, so two runs decode
    the same sequence."""
    import torch
    from acestep_tpu_torch.lm_pipeline import LMPipeline
    from acestep_tpu_torch.serving import kv_cache as kvc
    from acestep_tpu_torch.serving import lm as lm_serving

    padded = LMPipeline._bucket(list(ids))
    cache = kvc.init_cache(cfg.num_hidden_layers, 1, cfg.num_key_value_heads,
                           kvc.round_len(len(padded) + steps + 1), cfg.head_dim, "int8", dev)
    lg, cache = lm_serving.prefill(
        params, cfg, torch.tensor([padded], device=dev),
        torch.tensor([len(ids)], dtype=torch.int32, device=dev), cache, int8_act=int8_act)
    out = [lg.float().cpu()]
    for i in range(steps):
        tok = (out[-1] if forced is None else forced[i]).argmax(-1).to(dev)
        lg, cache = lm_serving.decode_step(params, cfg, cache, tok, decode_attn=decode_attn,
                                           int8_act=int8_act)
        cache.length = cache.length + 1
        out.append(lg.float().cpu())
    return out


def planner_logits_check(label, params, cfg, ids, rel_max, dev="cuda"):
    """The first PLANNER_LOGIT_STEPS decode steps' logits on each kernel path
    (decode_attn auto: row 1; pallas: rows 1 and 9; fused: rows 1 and 10;
    int8_act: row 6, and row 1 in the prefill) against the plain path on the
    card (the dequant matmul's and row 6's plain versions, the plain
    attention), both fed the plain run's tokens: max err / peak below
    ``rel_max`` at every step (with int8_act twice that, as INT8_LOGIT_REL is
    twice MEGA_REL: an activation's int8 value moves a whole step where a
    bf16 rounding before it differs, and the prefill's rows pass through row
    1) and the top token equal wherever the plain row's top-1 / top-2 gap is
    at least that bound of the peak.  Returns each kernel run's (launches,
    shapes)."""
    import torch

    runs, fails = [], []
    for int8 in (False, True):
        bound = rel_max * (INT8_LOGIT_REL / MEGA_REL if int8 else 1.0)
        reset_counts()
        with plain_qmm(), plain_int8():
            ref = planner_logits(params, cfg, ids, "auto", int8, dev=dev)
        require(not any(snapshot_counts()[0].values()), f"{label}: the plain path launched")
        for mode in (("auto",) if int8 else PLANNER_ATTN):
            reset_counts()
            got = planner_logits(params, cfg, ids, mode, int8, forced=ref, dev=dev)
            runs.append(snapshot_counts())
            worst, compared, bad = 0.0, 0, []
            for step, (r, g) in enumerate(zip(ref, got)):
                peak = float(r.abs().max())
                rel = float((g - r).abs().max()) / peak
                worst = max(worst, rel)
                top2 = torch.topk(r[0], 2).values
                sure = float(top2[0] - top2[1]) >= bound * peak
                compared += sure
                if (not bool(torch.isfinite(g).all()) or rel >= bound
                        or (sure and int(g.argmax()) != int(r.argmax()))):
                    bad.append(step)
            what = f"{label} decode_attn={mode}" + (" int8_act" if int8 else "")
            log(f"  {what}: {len(ref) - 1} decode steps, logits against the plain path "
                f"max err / peak {worst:.3e} (< {bound:.3e}), the top token equal at the "
                f"{compared} of {len(ref)} steps whose top-1/top-2 gap is at least that; "
                f"launches " + json.dumps({k: v for k, v in runs[-1][0].items() if v})
                + (f"; FAIL at steps {bad}" if bad else " ok"))
            if bad:
                fails.append(what)
    require(not fails, f"logits of {fails} disagree with the plain path")
    return runs


def planner_request(pipe, label, need, batch=1):
    """A PLANNER_CODES_S codes phase through generate_with_stop_condition
    (thinking off, bpm 100; ``batch`` candidates in one chunk), the counts set
    to 0 just before and read just after; every candidate exactly
    PLANNER_CODES codes in [0, 64000).  Returns (result, (launches, shapes))."""
    import numpy as np

    reset_counts()
    res = pipe.generate_with_stop_condition(
        LM_CAPTION, LM_LYRICS, PLANNER_CODES_S, thinking=False, user_metadata={"bpm": 100},
        temperature=0.85, top_p=0.95, batch_size=batch, chunk_size=batch, seed=0)
    counts = snapshot_counts()
    log(f"{label}: time_costs " + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
    log(f"{label}: launches " + json.dumps({k: v for k, v in counts[0].items() if v}))
    require(all(counts[0][n] > 0 for n in need), f"{label}: a kernel of the path was not "
            f"launched (need {need}, got {counts[0]})")
    require(len(res.candidates) == batch, f"{label}: {len(res.candidates)} candidates")
    for c in res.candidates:
        require(len(c) == PLANNER_CODES and c.dtype == np.int32 and int(c.min()) >= 0
                and int(c.max()) < 64000, f"{label}: codes {len(c)} in [{c.min()}, {c.max()}]")
    return res, counts


def planner_step_bound(cfg):
    """Least time of one codes-phase decode step at B 1: the layers' q8_0
    weights and the reduced codes head (65536 columns) as stored, once."""
    stored, _ = lm_weight_bytes(cfg)
    head = cfg.hidden_size * 65536 * (1 + 2 / 32)
    return (stored + head) / HBM_BYTES_PER_S * 1e3


def planner_step_line(label, cfg, res, counts, batch):
    """Log prefill ms, decode ms a step and launches a step by kernel of one
    codes phase (its decode steps counted by the qkv linear's launches at M =
    ``batch``), beside the step's bound."""
    from acestep_tpu_torch.ops.cuda import decode_attn, qmm, qmm_int8

    shapes = counts[1]
    qkv_n = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    key = (batch, cfg.hidden_size, qkv_n)
    names = (qmm.KERNELS["q8_0"].name, qmm_int8.INT8.name, decode_attn.ATTN.name,
             decode_attn.FUSED.name)
    steps = sum(shapes[name].get(key, 0) for name in names) / cfg.num_hidden_layers
    if not steps:               # a rehearsal on the CPU counts no launch
        return
    per = {}
    for name in names:
        n = sum(v for s, v in shapes[name].items() if s[0] == batch)
        if n:
            per[name] = round(n / steps, 3)
    tc = res.time_costs
    dec = tc["lm_phase2_decode_time_cost"] / steps * 1e3
    bound = planner_step_bound(cfg)
    log(f"{label}: prefill {tc['lm_phase2_prefill_time_cost'] * 1e3:.3f} ms; {steps:g} decode "
        f"steps, {dec:.3f} ms a step (bound {bound:.4f} ms at B 1, weights as stored over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {dec / bound:.1f}x); launches a step "
        + json.dumps(per))


def planner_timing(label, counts, batch):
    """Rows 1 and 6 at the decode shapes (M = ``batch``) of one codes phase:
    each shape timed alone (CUDA events, warm L2) and as a CUDA graph, beside
    its plain version, torch.matmul on the dequantized weight and its bound;
    weighted by its launches in the request."""
    import torch
    from acestep_tpu_torch.ops.cuda import qmm, qmm_int8

    shapes = counts[1]
    for name, launch, plain, bound in (
            (qmm.KERNELS["q8_0"].name, lambda c: qmm._launch(c.x, c.qt, None, torch.bfloat16),
             lambda c: qmm.qmm_plain(c.x, c.qt), lambda c: c.bound()),
            (qmm_int8.INT8.name, lambda c: qmm_int8._launch(c.x, c.qt),
             lambda c: qmm_int8.qmm_int8_act_plain(c.x, c.qt), lambda c: int8_bound(
                 c.m, c.k, c.n))):
        tot = {"ms": 0.0, "dev": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
        for i, (shape, cnt) in enumerate(sorted(shapes[name].items())):
            if shape[0] != batch:
                continue
            case = QmmCase("q8_0", *shape, 900 + i)
            ms = cuda_ms(lambda: launch(case), iters=20)
            dev = graph_ms(lambda: launch(case))
            pl = cuda_ms(lambda: plain(case), iters=3)
            lib = cuda_ms(lambda: torch.matmul(case.x, case.wd), iters=20)
            b, by = bound(case)
            log(f"  {name} M={shape[0]} K={shape[1]} N={shape[2]} x{cnt}: kernel {ms:.4f} ms, "
                f"CUDA graph {dev:.4f}, plain {pl:.4f}, library {lib:.4f}, bound {b:.4f} ({by})")
            for key, v in (("ms", ms), ("dev", dev), ("plain", pl), ("lib", lib), ("bound", b)):
                tot[key] += cnt * v
            del case
        if tot["ms"]:
            log(f"{name} per {label}: kernel {tot['ms']:.3f} ms, CUDA graph {tot['dev']:.3f}, "
                f"plain {tot['plain']:.3f}, library {tot['lib']:.3f}, bound {tot['bound']:.3f}")


def planner_attn_timing(cfg, lengths):
    """Rows 9 and 10 at the planner's heads, B 1, T 1024, at ``lengths``:
    kernel (eager and CUDA graph), plain and SDPA ms a launch, beside the
    bound."""
    from acestep_tpu_torch.ops.cuda import decode_attn

    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    for n in lengths:
        c = attn_case(1, [n], 310, t_max=1024, hq=hq, hkv=hkv)
        lib = sdpa_lib(c, 0, n)
        for name, fn, plain, a in (
                (decode_attn.ATTN.name, decode_attn.decode_attention_int8_stacked,
                 decode_attn.decode_attention_plain, attn_args(c, 0)),
                (decode_attn.FUSED.name, decode_attn.decode_attention_fused_stacked,
                 decode_attn.decode_attention_fused_plain, fused_args(c, 0))):
            for _ in range(decode_attn.POOL + 1):
                fn(*a)
            ms = cuda_ms(lambda: fn(*a), iters=decode_attn.POOL)
            dev = graph_ms(lambda: fn(*a))
            pl = cuda_ms(lambda: plain(*a), iters=5)
            nbytes = hkv * n * (128 + 4) * 2 + hq * 128 * 2 + 2 * hkv * 128 * 2 + hq * 128 * 4
            b, by = bound_ms(nbytes, 4.0 * hq * n * 128, BF16_FLOPS)
            log(f"  {name} B=1 Hq={hq} Hkv={hkv} T=1024 length {n}: kernel {ms * 1e3:.2f} us "
                f"eager, {dev * 1e3:.2f} us device; plain {pl:.4f} ms; library (SDPA, "
                f"dequantization excluded) {cuda_ms(lib, iters=20) * 1e3:.2f} us; bound "
                f"{b * 1e3:.3f} us ({by})")
        del c


def planners_phase(engine, style, lyric, recheck, check_int8_at, check_attn_at, rel_max,
                   dev="cuda"):
    """Phase planners: the 1.7B drawn on the card in bf16, written in the
    reference layout with the demo vocabulary's tokenizer.json, converted at
    q8_0 (``convert_checkpoint --lm``) and built with ``build_lm``: its
    leaves equal the drawn tree quantized in memory, configs[2]'s song
    through ``generate_music`` with ``engine`` (+think on the device DFA, two
    candidates ranked by PMI), one codes phase with int8_act; the 4B drawn at
    q8_0, saved with ``save_params`` beside ``lm.config.json`` and the
    tokenizer, built with ``build_lm``: a 10 s codes phase with decode_attn
    auto, pallas and fused, and with int8_act at 16 candidates (every linear
    at M 16).  Row 11 declines both widths and launches 0 times; each
    planner's first decode steps on every kernel path are held to the plain
    path (``rel_max``: check_mega's bound); every launched shape of rows 1,
    6, 9 and 10 is held to its plain version (``recheck``, ``check_int8_at``,
    ``check_attn_at``).  Returns the launches by kernel name.  With ``dev``
    "cpu" (and small configs patched in) it rehearses the phase: the plain
    versions run, so no launch is asked for, checked or timed."""
    import io
    import shutil

    import numpy as np
    import torch

    from acestep_tpu_torch import convert_checkpoint, inference, lm_pipeline, loader, pipeline
    from acestep_tpu_torch.config import QWEN3_1_7B, QWEN3_4B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.ops.cuda import decode_attn, decode_mega, qmm, qmm_int8
    from acestep_tpu_torch.quant.convert import importer_policy, quantize_tree
    from acestep_tpu_torch.serving import launch

    q8, int8 = qmm.KERNELS["q8_0"].name, qmm_int8.INT8.name
    attn, fused, mega = decode_attn.ATTN.name, decode_attn.FUSED.name, decode_mega.MEGA.name
    card = dev == "cuda"

    def need(*names):
        return list(names) if card else []

    def gib(stat):
        return getattr(torch.cuda, stat)() / 2**30 if card else 0.0

    work = tempfile.TemporaryDirectory(prefix="acestep_planners_")
    t_phase = time.perf_counter()
    if card:
        torch.cuda.reset_peak_memory_stats()
    runs, total = [], {}

    def keep(counts):
        runs.append(counts)
        add_counts(total, counts)

    def codes_ids(pipe):
        return pipe.tok.encode(lm_pipeline.build_formatted_prompt_with_cot(
            LM_CAPTION, LM_LYRICS, lm_pipeline.metadata_to_cot({"bpm": 100})))

    # (a) the 1.7B through the converter
    cfg = QWEN3_1_7B
    t = time.perf_counter()
    tree = RandomInit(torch.device(dev), seed=41, quant=None).qwen(cfg)
    tree["layers"] = unstack_layer_params(tree["layers"])
    src, out17 = os.path.join(work.name, "reference_1_7b"), os.path.join(work.name, "lm_1_7b")
    size = qwen_reference(tree).write(src, cfg)
    demo_tokenizer_json(os.path.join(src, "tokenizer.json"), cfg.vocab_size)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = convert_checkpoint.main(["--lm", src, "--lm-quant", "q8_0", "--out", out17])
    conv_s = time.perf_counter() - t
    require(rc == 0, f"convert_checkpoint --lm exited {rc}")
    shutil.rmtree(src)
    t = time.perf_counter()
    lm17 = launch.build_lm(out17, device=dev, decode_attn="fused")
    sync()
    build_s = time.perf_counter() - t
    require(lm17 is not None and isinstance(lm17.tok, lm_pipeline.TokenizerJsonAdapter),
            "build_lm found no planner in the converted directory")
    bad = tree_mismatches(loader.load_params(os.path.join(out17, "lm"), device=dev),
                          quantize_tree(tree, "q8_0", importer_policy))
    require(not bad, f"the converted 1.7B's leaves differ from quantize_tree's: {bad[:6]}")
    del tree
    free_engine()
    log(f"1.7B: bf16 drawn on the card and written in the reference layout ({size / 2**30:.3f} "
        f"GiB) in {write_s:.1f} s; convert_checkpoint --lm --lm-quant q8_0 on the host "
        f"{conv_s:.3f} s; build_lm {build_s:.3f} s; every converted leaf equal bit for bit to "
        f"the drawn tree quantized in memory (quant.convert.quantize_tree); tokenizer ids: EOS "
        f"{lm17.tok.eos_token_id}, </think> {lm17.tok.think_end_id}, codes from "
        f"{lm17.tok.audio_code_base_id}; device memory {gib('memory_allocated'):.2f} GiB")
    require(not decode_mega.supported(lm17.params["layers"], cfg, 1, LM_T),
            "row 11 takes the 1.7B: the JAX megakernel declines hidden 2048")
    params = inference.GenerationParams(
        caption=LM_CAPTION, lyrics=LM_LYRICS, duration=LM_DURATION_S, style_token_ids=style,
        lyric_token_ids=lyric, thinking=True, lm_num_candidates=PLANNER_CANDIDATES)
    reset_counts()
    song = inference.generate_music(engine, lm17, params)
    counts = snapshot_counts()
    keep(counts)
    label = "1.7B configs[2] song (+think, 2 candidates, decode_attn=fused)"
    log(f"{label}: time_costs " + json.dumps({k: round(v, 6)
                                              for k, v in song.time_costs.items()}))
    log(f"{label}: launches " + json.dumps({k: v for k, v in counts[0].items() if v}))
    lm_res, md = song.lm_result, song.metadata
    require(all(counts[0][n] > 0 for n in need(q8, fused)) and counts[0][mega] == 0,
            f"{label}: launches {counts[0]}")
    require(lm_res.cot_route == "device_dfa", f"{label}: the CoT took {lm_res.cot_route}")
    require(len(lm_res.candidates) == PLANNER_CANDIDATES
            and "lm_ranking_time_cost" in song.time_costs, f"{label}: no PMI ranking")
    c = lm_res.code_indices
    require(len(c) == LM_CODES and int(c.min()) >= 0 and int(c.max()) < 64000,
            f"{label}: codes {len(c)} in [{c.min()}, {c.max()}]")
    require(all(str(md.get(k, "")).strip() for k in ("bpm", "keyscale", "timesignature",
                                                     "language", "caption", "genres")),
            f"{label}: metadata {md}")
    n_song = pipeline.frames_for_duration(LM_DURATION_S) * engine.vae_cfg.hop_length
    check_audio([song.dit_result], n_song)
    require(song.pcm16().shape == (1, n_song, 2), f"{label}: audio {song.pcm16().shape}")
    log(f"{label}: {len(lm_res.cot_ids)} CoT tokens, metadata "
        + json.dumps({k: md[k] for k in sorted(md)}))
    planner_step_line(f"{label} codes phase", cfg, lm_res, counts, PLANNER_CANDIDATES)
    res, counts = planner_request(lm_pipeline.LMPipeline(lm17.params, cfg, lm17.tok, device=dev,
                                                         decode_attn="fused", int8_act=True),
                                  "1.7B codes phase, int8_act, decode_attn=fused",
                                  need(int8, fused))
    keep(counts)
    planner_step_line("1.7B codes phase, int8_act, decode_attn=fused", cfg, res, counts, 1)
    for r in planner_logits_check("1.7B", lm17.params, cfg, codes_ids(lm17), rel_max, dev):
        keep(r)
    peak17 = gib("max_memory_allocated")
    del lm17, song
    shutil.rmtree(out17)
    free_engine()

    # (b) the 4B through a saved checkpoint
    cfg = QWEN3_4B
    t = time.perf_counter()
    p4 = qwen.init_params(cfg, device=dev, seed=43, quant="q8_0")
    p4["layers"] = unstack_layer_params(p4["layers"])
    out4 = os.path.join(work.name, "ckpt_4b")
    os.makedirs(out4)
    loader.save_params(os.path.join(out4, "lm"), p4)
    with open(os.path.join(out4, "lm.config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    demo_tokenizer_json(os.path.join(out4, "tokenizer.json"), cfg.vocab_size)
    save_s = time.perf_counter() - t
    del p4
    free_engine()
    t = time.perf_counter()
    pipe4 = launch.build_lm(out4, device=dev)
    sync()
    build_s = time.perf_counter() - t
    work.cleanup()
    log(f"4B: q8_0 drawn on the card and saved with save_params in {save_s:.1f} s; build_lm "
        f"{build_s:.3f} s; device memory {gib('memory_allocated'):.2f} GiB")
    require(not decode_mega.supported(pipe4.params["layers"], cfg, 1, LM_T),
            "row 11 takes the 4B: the JAX megakernel declines hidden 2560")
    reqs = {}
    for mode, path in (("auto", need(q8)), ("pallas", need(q8, attn)),
                       ("fused", need(q8, fused))):
        p = pipe4 if mode == "auto" else lm_pipeline.LMPipeline(
            pipe4.params, cfg, pipe4.tok, device=dev, decode_attn=mode)
        for i in range(2 if mode == "auto" else 1):
            label = f"4B codes phase, decode_attn={mode}" + (" (warm-up)" if i == 0 and
                                                               mode == "auto" else "")
            reqs[mode] = planner_request(p, label, path)
            keep(reqs[mode][1])
        planner_step_line(f"4B codes phase, decode_attn={mode}", cfg, *reqs[mode], 1)
    label = f"4B codes phase, int8_act, {PLANNER_INT8_BATCH} candidates"
    reqs["int8"] = planner_request(lm_pipeline.LMPipeline(pipe4.params, cfg, pipe4.tok,
                                                          device=dev, int8_act=True),
                                   label, need(int8), batch=PLANNER_INT8_BATCH)
    keep(reqs["int8"][1])
    planner_step_line(label, cfg, *reqs["int8"], PLANNER_INT8_BATCH)
    by_m = {}
    for (m, k, n), v in reqs["int8"][1][1][int8].items():
        by_m.setdefault(m, 0)
        by_m[m] += v
    h, inter = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.num_attention_heads * cfg.head_dim
    hit = {s: reqs["int8"][1][1][int8].get(s, 0) for s in ((16, inter, h), (16, qdim, h))}
    log(f"{label}: row 6 launches by M " + json.dumps({str(k): v for k, v in sorted(by_m.items())})
        + "; at the shapes that had no plan: " + json.dumps({str(k): v for k, v in hit.items()}))
    require(all(hit.values()) or not card, f"{label}: down_proj or o_proj never ran row 6 at M 16")
    for r in planner_logits_check("4B", pipe4.params, cfg, codes_ids(pipe4), rel_max, dev):
        keep(r)
    peak4 = gib("max_memory_allocated")

    # (c) every launched shape against its plain version, then the times
    require(total.get(mega, 0) == 0, f"row 11 launched {total.get(mega)} times in the phase")
    if card:
        for _, shapes in runs:
            recheck(shapes, 95)
            for shape in shapes[int8]:
                check_int8_at(shape)
            for name, is_fused in ((attn, False), (fused, True)):
                for shape in shapes[name]:
                    check_attn_at(shape, is_fused)
        for mode, batch in (("auto", 1), ("int8", PLANNER_INT8_BATCH)):
            planner_timing(f"4B codes phase ({mode}, B {batch})", reqs[mode][1], batch)
        planner_attn_timing(cfg, (64, 128))
    del pipe4
    free_engine()
    log(f"phase planners: {time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{peak17:.2f} GiB (1.7B), {peak4:.2f} GiB (4B); row 11 launches 0; launches "
        + json.dumps({k: v for k, v in total.items() if v}))
    return total


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase tp: serving from a (dp, tp) group of processes (torch.distributed)
# ---------------------------------------------------------------------------

TP_CHILD_S = 420               # each world's limit; a rank still running then is killed
TP_LM_PROMPT = 200             # prompt tokens of the planner's codes phase in phase tp
TP_LM_STEPS = 24               # its greedy codes (random weights: a close call comes early)
TP_WITNESS_DRAWS = 3           # noise draws of the waveform witness (TpPhase.gate_pair)
TP_WITNESS_MARGIN_DB = 3.0     # how far the world's waveform SNR may fall below the witness's
TP_TRAIN_LAYERS = 2            # the train job's full-width DiT cut to one sliding, one full layer
TP_TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)   # the CPU tests' (2 steps)
TP_UPDATE_TOL = 1.5 * 0.0517   # tests/test_torch_training.py's UPDATE_TOL
TP_LOSS_RTOL = 1e-3            # its per-step loss bound (test_three_steps_match_jax)
TP_MAP_ATOL, TP_SCORE_RTOL = 2e-3, 5e-3   # tests/test_torch_alignment.py's MAP_ATOL, ENGINE_SCORE_RTOL
TP_PAYLOAD = 2048              # floats of a merged request broadcast by rank 0's batcher


def tp_lm_prompt():
    import numpy as np

    return np.random.default_rng(11).integers(0, 50000, (1, TP_LM_PROMPT))


def tp_lm_sp():
    from acestep_tpu_torch.serving import lm as lm_serving

    tok = ByteTokenizer()
    return lm_serving.SamplingParams(
        temperature=0.0, max_new_tokens=TP_LM_STEPS,
        allowed_range=(tok.audio_code_base_id, tok.audio_code_base_id + 64000),
        eos_token=tok.eos_token_id)


def _shapes_json(shapes):
    return {name: [[list(k) if isinstance(k, tuple) else k, v] for k, v in by.items()]
            for name, by in shapes.items()}


def tp_engine_job(mesh, job, out, meta):
    """A full-width random engine on the mesh serving ``job``'s requests, the
    counts reset before each and read after it; the lyric alignment probe of
    the requests ``job["align"]`` names on their latents; ``job["batcher"]``'s
    requests through rank 0's batcher (:func:`tp_batcher`)."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline

    t = time.perf_counter()
    engine = pipeline.build_random_engine(quant=job["quant"], seed=0, mesh=mesh)
    torch.cuda.synchronize(mesh.device)
    meta["build_s"] = time.perf_counter() - t
    for name, req in job["requests"].items():
        reset_counts()
        t = time.perf_counter()
        res = engine.generate(pipeline.GenerationRequest(**req))
        torch.cuda.synchronize(mesh.device)
        launches, shapes = snapshot_counts()
        out[f"{name}/latents"], out[f"{name}/audio"] = res.latents, res.audio_i16
        meta[name] = {"seconds": time.perf_counter() - t, "launches": launches,
                      "shapes": _shapes_json(shapes), "time_costs": res.time_costs}
        if name not in job.get("align", ()):
            continue
        reset_counts()
        t = time.perf_counter()
        r = pipeline.GenerationRequest(**req)
        out[f"{name}/align_map"], _ = engine.lyric_attention_map(res.latents, r)
        out[f"{name}/align_stamps"], _ = engine.get_lyric_timestamps(res.latents, r)
        out[f"{name}/align_score"] = np.float64(engine.get_lyric_score(res.latents, r))
        torch.cuda.synchronize(mesh.device)
        launches, shapes = snapshot_counts()
        meta[f"{name} align"] = {"seconds": time.perf_counter() - t, "launches": launches,
                                 "shapes": _shapes_json(shapes)}
    if job.get("batcher"):
        tp_batcher(engine, mesh, job["batcher"], out, meta)
    del engine
    free_engine()


def tp_encode_request(req):
    """A merged request as rank 0 broadcasts it: [1 (run), batch, style width,
    lyric width, duration, the seeds at 5..], then from 16 the style ids, their
    mask, the lyric ids, their mask (a merged request's ids are padded to
    their token bucket, so the widths travel explicitly; ids < 2^24 are exact
    in f32)."""
    import numpy as np

    buf = np.zeros(TP_PAYLOAD, np.float32)
    parts = [np.asarray(v).ravel() for v in (req.style_token_ids, req.style_mask,
                                               req.lyric_token_ids, req.lyric_mask)]
    buf[:5] = (1.0, req.batch_size, req.style_token_ids.shape[1], req.lyric_token_ids.shape[1],
               req.duration_s)
    buf[5:5 + len(req.seeds)] = req.seeds
    flat = np.concatenate(parts)
    require(16 + flat.size <= TP_PAYLOAD, f"a merged request of {flat.size} ids overflows "
            f"the {TP_PAYLOAD}-float payload")
    buf[16:16 + flat.size] = flat
    return buf


def tp_decode_request(buf):
    import numpy as np
    from acestep_tpu_torch import pipeline

    b, ws, wl, dur = int(buf[1]), int(buf[2]), int(buf[3]), float(buf[4])
    sizes = [b * ws, b * ws, b * wl, b * wl]
    offs = np.cumsum([16] + sizes)
    sid, smask, lid, lmask = (buf[o:o + n].astype(np.int64).reshape(b, -1)
                              for o, n in zip(offs, sizes))
    return pipeline.GenerationRequest(
        duration_s=dur, durations_s=[dur] * b, batch_size=b, style_token_ids=sid,
        style_mask=smask.astype(np.int32), lyric_token_ids=lid,
        lyric_mask=lmask.astype(np.int32), seeds=[int(x) for x in buf[5:5 + b]])


def tp_batcher(engine, mesh, reqs, out, meta):
    """Rank 0's continuous batcher over the mesh (tests/test_distributed_multiproc.py
    :126-179 in the JAX package): rank 0 merges ``reqs`` and broadcasts each
    merged request as a fixed-size payload; every other rank loops on the
    broadcast and runs the same ``generate``; a zero payload ends the loop."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.parallel import distributed
    from acestep_tpu_torch.serving.batcher import ContinuousBatcher

    def bcast(buf):
        return distributed.broadcast(torch.from_numpy(buf).to(mesh.device),
                                     mesh.world).cpu().numpy()

    reset_counts()
    t = time.perf_counter()
    if mesh.world.index == 0:
        def run_merged(req):
            if mesh.device.type == "cuda":
                torch.cuda.set_device(mesh.device)       # the worker thread's device
            bcast(tp_encode_request(req))
            return engine.generate(req)

        bat = ContinuousBatcher(run_merged, max_batch=len(reqs), max_wait_s=5.0).start()
        futs = [bat.submit(pipeline.GenerationRequest(**dict(
            r, style_token_ids=np.asarray(r["style_token_ids"]),
            lyric_token_ids=np.asarray(r["lyric_token_ids"])))) for r in reqs]
        results = [f.result(timeout=TP_CHILD_S) for f in futs]
        bat.stop()
        bcast(np.zeros(TP_PAYLOAD, np.float32))
        batches = bat.stats["batches"]
    else:
        results = []
        while True:
            buf = bcast(np.zeros(TP_PAYLOAD, np.float32))
            if buf[0] < 0.5:
                break
            results.append(engine.generate(tp_decode_request(buf)))
        batches = len(results)
    torch.cuda.synchronize(mesh.device)
    launches, shapes = snapshot_counts()
    out["batcher/latents"] = np.concatenate([r.latents for r in results])
    out["batcher/audio"] = np.concatenate([r.audio_i16 for r in results])
    meta["batcher"] = {"seconds": time.perf_counter() - t, "launches": launches,
                       "shapes": _shapes_json(shapes), "batches": batches}


def tp_train_cfg():
    """The train job's DiT: full width, TP_TRAIN_LAYERS decoder layers, no
    lyric or timbre encoder (the loss reads neither)."""
    from acestep_tpu_torch.config import DiTConfig

    return dataclasses.replace(DiTConfig(), num_hidden_layers=TP_TRAIN_LAYERS, layer_types=(),
                               num_lyric_encoder_hidden_layers=0,
                               num_timbre_encoder_hidden_layers=0)


def tp_train_inputs(device):
    """(config, the groups the loss reads of an f32 DiT drawn by RandomInit
    seed 7 as per-layer lists, phase train's batch, two steps' draws made
    with numpy): the same on every rank and in the one process."""
    import numpy as np
    import torch
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.sampler import SHIFT_TIMESTEPS
    from acestep_tpu_torch.training.flow_matching import loss_params

    cfg = tp_train_cfg()
    tree = loss_params(list_tree(RandomInit(torch.device(device), 7, None,
                                            dtype=torch.float32), cfg))
    batch = train_batch(cfg, device)
    rng = np.random.default_rng(21)
    sched = np.asarray(SHIFT_TIMESTEPS[3.0], np.float32)
    draws = [(torch.from_numpy(sched[rng.integers(0, sched.size, 2)]).to(device),
              torch.from_numpy(rng.standard_normal(tuple(batch["latents"].shape))
                               .astype(np.float32)).to(device)) for _ in range(2)]
    return cfg, tree, batch, draws


def tp_tree_digest(tree):
    """sha256 of a tree's leaves' bytes, in order, as uint8."""
    import hashlib

    import numpy as np
    import torch
    from acestep_tpu_torch.weights import tree_leaves

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def tp_update_rel(got, ref, p0):
    """(max over leaves of |got update - ref update| / |ref update| (norms, f64
    on the device), that leaf's name, leaves bit-equal to ``ref``, leaves)."""
    import torch
    from acestep_tpu_torch.weights import flatten

    g_f, r_f, a_f = flatten(got), flatten(ref), flatten(p0)
    worst, name, equal = 0.0, "", 0
    for n, a in a_f.items():
        g, r = g_f[n], r_f[n]
        equal += int(torch.equal(g, r))
        du = r.double() - a.double()
        err = float(torch.linalg.vector_norm(g.double() - a.double() - du))
        rel = err / max(float(torch.linalg.vector_norm(du)), 1e-300) if err else 0.0
        if rel > worst:
            worst, name = rel, n
    return worst, name, equal, len(a_f)


def tp_train_job(mesh, job, out, meta):
    """Two ``make_tp_train_step`` steps of the full-width DiT cut to
    TP_TRAIN_LAYERS on the rank's shards and dp rows; the whole tree gathered
    back; rank 0 holds it to the one process's (``job["ref"]``, written by
    the parent)."""
    import numpy as np
    import torch
    from acestep_tpu_torch.parallel import shard_params
    from acestep_tpu_torch.parallel.sharding import unshard_params
    from acestep_tpu_torch.parallel.tp import make_tp_train_step
    from acestep_tpu_torch.training.flow_matching import make_optimizer

    cfg, tree, batch, draws = tp_train_inputs(mesh.device)
    opt = make_optimizer(**TP_TRAIN_OPT)
    params = shard_params(tree, mesh)
    if mesh.rank != 0:
        tree = None
    state = opt.init(params)
    step = make_tp_train_step(cfg, opt, mesh)
    reset_counts()
    t0, secs, losses = time.perf_counter(), [], []
    for t_d, noise in draws:
        torch.cuda.synchronize(mesh.device)
        t = time.perf_counter()
        params, state, loss = step(params, state, batch, t_d, noise)
        torch.cuda.synchronize(mesh.device)
        secs.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches, shapes = snapshot_counts()
    whole = unshard_params(params, mesh)
    out["train/losses"] = np.asarray(losses, np.float32)
    out["train/digest"] = tp_tree_digest(whole)
    run = {"seconds": time.perf_counter() - t0, "launches": launches,
           "shapes": _shapes_json(shapes), "count": state.count}
    if mesh.rank == 0:
        ref = torch.load(job["ref"], map_location=mesh.device)
        run["update_rel"], run["worst_leaf"], run["equal_leaves"], run["leaves"] = \
            tp_update_rel(whole, ref["tree"], tree)
        run["ref_losses"] = ref["losses"]
    del whole, tree
    # a third step, warm, timed only
    torch.cuda.synchronize(mesh.device)
    t = time.perf_counter()
    step(params, state, batch, *draws[1])
    torch.cuda.synchronize(mesh.device)
    run["step_s"] = secs + [time.perf_counter() - t]
    meta["train"] = run


def tp_lm_job(mesh, job, out, meta):
    """configs[2]'s 0.6B q8_0 planner (phase lm_engine's weights) on the mesh:
    the greedy codes phase on each decode_attn kernel (rows 9 and 10 at the
    rank's KV heads)."""
    import torch
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.parallel.lm_tp import LMTPContext
    from acestep_tpu_torch.serving import lm as lm_serving

    p = lm_serving.ensure_quantized_head(qwen.stack_params(
        qwen.init_params(QWEN3_0_6B, device=mesh.device, seed=7, quant="q8_0")))
    ctx = LMTPContext(p, QWEN3_0_6B, mesh)
    del p
    free_engine()
    ids = torch.from_numpy(tp_lm_prompt()).to(mesh.device)
    lens = torch.tensor([TP_LM_PROMPT], dtype=torch.int32, device=mesh.device)
    for mode in job["modes"]:
        ctx.knobs = dict(decode_attn=mode)
        reset_counts()
        t = time.perf_counter()
        toks, n = ctx.generate(ids, lens, None, tp_lm_sp())
        torch.cuda.synchronize(mesh.device)
        launches, shapes = snapshot_counts()
        out[f"{mode}/tokens"], out[f"{mode}/n"] = toks.cpu().numpy(), n.cpu().numpy()
        meta[mode] = {"seconds": time.perf_counter() - t, "launches": launches,
                      "shapes": _shapes_json(shapes)}


def tp_rank_main(spec_path: str, rank: int) -> int:
    """One rank of a phase-tp world (``chip_smoke.py --tp-rank SPEC RANK``):
    join the group, form each job's mesh, run it, write this rank's outputs
    and a JSON of its times, launches and peak memory."""
    import numpy as np
    import torch
    from acestep_tpu_torch.parallel import distributed, make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    # the library picks and sets the rank's card, as under torchrun: NCCL
    # takes cuda:LOCAL_RANK; the one-card gloo worlds name their device
    distributed.initialize(spec["backend"], spec["init_method"], spec["world"], rank)
    device = (torch.device(spec["devices"][rank]) if spec["backend"] == "gloo"
              else distributed.default_device())
    # one collective over the whole world on the backend itself
    ones = torch.ones(1, device=device)
    ones = ones.cpu() if spec["backend"] == "gloo" else ones
    torch.distributed.all_reduce(ones)
    if int(ones.item()) != spec["world"]:
        raise RuntimeError(f"all_reduce of ones over the world gave {ones.item()}")
    out, meta = {}, {"init_s": time.perf_counter() - t0}
    for i, job in enumerate(spec["jobs"]):
        mesh = make_mesh(dp=job["mesh"][0], tp=job["mesh"][1],
                         device=device if spec["backend"] == "gloo" else None)
        require(torch.cuda.current_device() == device.index,
                f"rank {rank}: the current device is cuda:{torch.cuda.current_device()}, "
                f"not the mesh's {device}")
        res, m = {}, {}
        TP_JOBS[job["kind"]](mesh, job, res, m)
        out.update({f"{i}/{k}": v for k, v in res.items()})
        meta[str(i)] = m
    meta["seconds"] = time.perf_counter() - t0
    meta["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    np.savez(os.path.join(spec["work"], f"rank{rank}.npz"), **out)
    with open(os.path.join(spec["work"], f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()
    return 0


TP_JOBS = {"engine": tp_engine_job, "lm": tp_lm_job, "train": tp_train_job}


def tp_world(label, backend, devices, jobs, work):
    """Spawn one rank a device of ``devices`` (``chip_smoke.py --tp-rank``),
    each with its output in ``work``; every rank must end with code 0 within
    TP_CHILD_S (the rest are killed, and the watchdog kills them too).  Returns
    (each rank's arrays, each rank's JSON)."""
    import numpy as np
    import torch

    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"world": len(devices), "backend": backend, "devices": devices,
                   "init_method": "file://" + os.path.join(work, "store"), "work": work,
                   "jobs": jobs}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in range(len(devices))]
    # each rank's LOCAL_RANK is its card's index, as torchrun sets it
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", spec_path,
                               str(r)], stdout=logs[r], stderr=subprocess.STDOUT, cwd=here,
                              env=dict(os.environ, LOCAL_RANK=str(torch.device(d).index),
                                       LOCAL_WORLD_SIZE=str(len(devices))))
             for r, d in enumerate(devices)]
    _state["children"] = procs
    deadline = time.perf_counter() + TP_CHILD_S
    failed = None
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                failed = (r, f"still running after {TP_CHILD_S} s")
                break
            if rc != 0:
                failed = (r, f"exit code {rc}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        _state["children"] = []
    if failed is not None:
        with open(os.path.join(work, f"rank{failed[0]}.log")) as f:
            tail = f.read()[-4000:]
        log(f"world {label}, rank {failed[0]} log (end):\n{tail}")
        raise Failure(f"phase tp: world {label} failed: rank {failed[0]} {failed[1]}")
    arrays, metas = [], []
    for r in range(len(devices)):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
        with open(os.path.join(work, f"rank{r}.json")) as f:
            metas.append(json.load(f))
    return arrays, metas


def tp_same_on_every_rank(label, arrays):
    import numpy as np

    for key in arrays[0]:
        for r, a in enumerate(arrays[1:], 1):
            require(np.array_equal(a[key], arrays[0][key]),
                    f"phase tp: world {label}: rank {r}'s {key} differs from rank 0's")
    log(f"  world {label}: every rank's outputs equal bit for bit ({len(arrays[0])} arrays, "
        f"{len(arrays)} ranks)")


def engine_decode(engine, latents):
    """``engine``'s own decode of [B, T_valid, 64] latents, as ``generate``
    runs it (segments reconciled for a batch-1 song of two or more windows,
    else one pass): int16 [B, L, 2]."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline

    lat = torch.from_numpy(latents).to(engine.device)
    plan = engine.plan(lat.shape[0], lat.shape[1])
    handles = (pipeline.decode_segments(engine.vae_params, engine.vae_cfg, lat, plan)
               if lat.shape[0] == 1 else [])
    if handles:
        segments, _ = pipeline.reconcile_segments(
            [(i16.cpu().numpy(), float(s)) for i16, s in handles], 2)
        return np.concatenate(segments, axis=1)
    i16, _ = pipeline.decode_one_pass(engine.vae_params, engine.vae_cfg, lat, plan)
    return i16.cpu().numpy().reshape(lat.shape[0], -1, 2)


def tp_lm_reference(params, mode):
    """The single-process greedy codes phase (phase lm_engine's fused params,
    the layer scan on ``mode``'s kernel) and, replaying its tokens, each step's
    top-1 / top-2 gap of the allowed logits over their peak."""
    import torch
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.serving import kv_cache as kvc
    from acestep_tpu_torch.serving import lm as lm_serving

    sp = tp_lm_sp()
    ids = torch.from_numpy(tp_lm_prompt()).cuda()
    lens = torch.tensor([TP_LM_PROMPT], dtype=torch.int32, device="cuda")
    toks, _ = lm_serving.generate(params, QWEN3_0_6B, ids, lens, None, sp, decode_mega="0",
                                  decode_attn=mode)
    toks = toks[0].cpu()
    lo, hi = sp.allowed_range
    cache = kvc.init_cache(QWEN3_0_6B.num_hidden_layers, 1, QWEN3_0_6B.num_key_value_heads,
                           kvc.round_len(TP_LM_PROMPT + TP_LM_STEPS + 1), QWEN3_0_6B.head_dim,
                           device="cuda")
    logits, cache = lm_serving.prefill(params, QWEN3_0_6B, ids, lens, cache)
    allowed = torch.zeros(logits.shape[-1], dtype=torch.bool, device="cuda")
    allowed[lo:hi] = True
    allowed[sp.eos_token] = True
    one = torch.ones((1,), dtype=torch.bool, device="cuda")
    gaps = []
    for i in range(TP_LM_STEPS):
        lg = torch.where(allowed, logits[0], float("-inf"))
        top = torch.topk(lg, 2).values
        gaps.append(float((top[0] - top[1]) / lg[allowed].abs().max()))
        if i + 1 < TP_LM_STEPS:
            logits, cache = lm_serving.decode_step(params, QWEN3_0_6B, cache,
                                                   toks[i:i + 1].cuda(), decode_mega="0",
                                                   decode_attn=mode)
            cache = kvc.advance(cache, one)
    return toks.numpy(), gaps


class TpPhase:
    """Phase tp (module docstring): the worlds and their checks against the
    single-process results of the earlier phases (``results``), phase
    lm_engine's planner (``lm_params``) and the drift check_mega measured
    at 28 layers (the plain decode step's x on the card against the CPU,
    max error over the peak); the train job's one-process steps are run
    here first (:meth:`train_reference`)."""

    def __init__(self, results, lm_params, mega_drift, recheck_shapes, check_attn_shape):
        import numpy as np

        self.t0 = time.perf_counter()
        self.work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                 "tp_phase")
        self.mega_drift = mega_drift
        self.recheck_shapes, self.check_attn_shape = recheck_shapes, check_attn_shape
        rng = np.random.default_rng(0)
        style, lyric = rng.integers(0, 150000, (1, 64)), rng.integers(0, 150000, (1, 256))
        r10 = dict(duration_s=10.0, style_token_ids=style.tolist(),
                   lyric_token_ids=lyric.tolist(), seeds=[1])
        self.requests = {"10s": r10, "60s": dict(r10, duration_s=60.0),
                         "b2": dict(r10, batch_size=2,
                                    style_token_ids=np.repeat(style, 2, 0).tolist(),
                                    lyric_token_ids=np.repeat(lyric, 2, 0).tolist(),
                                    seeds=[1, 2])}
        # the items of the batch of two, each alone: rank 0's batcher merges them
        self.batcher_items = [dict(r10, seeds=[s]) for s in self.requests["b2"]["seeds"]]
        self.refs = {"10s": results["10s"][-1], "60s": results["60s q4_k"][-1],
                     "b2": results["b2"][-1]}
        self.modes = ("pallas", "fused")
        self.lm_ref = {m: tp_lm_reference(lm_params, m) for m in self.modes}
        self.launched, self.decoders = {}, {}
        attn, fused = decode_attn_names()
        need10 = ["q8_0_qmm", "vae_res_unit", "vae_res_trio"]
        self.need = {"10s": need10, "b2": need10, "60s": need10 + ["q4_k_qmm"],
                     "pallas": [attn, "q8_0_qmm"], "fused": [fused, "q8_0_qmm"],
                     "10s align": ["q8_0_qmm"], "batcher": need10, "train": []}
        self.train_ref = os.path.join(self.work, "train_ref.pt")
        self.train_reference()

    def train_reference(self):
        """The train job's two steps in one process (``make_train_step``),
        written for the ranks to hold their trees to."""
        import torch
        from acestep_tpu_torch.training.flow_matching import make_optimizer, make_train_step
        from acestep_tpu_torch.weights import tree_leaves

        cfg, tree, batch, draws = tp_train_inputs("cuda")
        opt = make_optimizer(**TP_TRAIN_OPT)
        state, step, secs, losses = opt.init(tree), make_train_step(cfg, opt), [], []
        for t_d, noise in draws + draws[1:]:          # the third step, warm, timed only
            sync()
            t = time.perf_counter()
            new, new_state, loss = step(tree, state, batch, t_d, noise)
            sync()
            secs.append(time.perf_counter() - t)
            if len(losses) < len(draws):
                tree, state = new, new_state
                losses.append(float(loss))
        del new, new_state
        os.makedirs(self.work, exist_ok=True)
        torch.save({"tree": tree, "losses": losses}, self.train_ref)
        n = sum(x.numel() for x in tree_leaves(tree))
        log(f"  train reference: one process, the full-width DiT cut to {TP_TRAIN_LAYERS} "
            f"layers, f32, {n / 1e6:.1f} M parameters, batch 2 x {TRAIN_T} frames: steps "
            + ", ".join(f"{x:.3f}" for x in secs) + f" s (the first a warm-up, the third "
            f"timed only); losses {losses}")
        del tree, state
        free_engine()

    def engine_job(self, mesh, quant, name, align=False, batcher=False):
        job = {"kind": "engine", "mesh": list(mesh), "quant": quant,
               "requests": {name: self.requests[name]}}
        if align:
            job["align"] = [name]
        if batcher:
            job["batcher"] = self.batcher_items
        return job

    def lm_job(self, mesh):
        return {"kind": "lm", "mesh": list(mesh), "modes": list(self.modes)}

    def train_job(self, mesh):
        return {"kind": "train", "mesh": list(mesh), "ref": self.train_ref}

    def one_process(self, quant):
        """The one-process engine of ``quant`` (seed 0, as every rank's),
        built once at a time."""
        from acestep_tpu_torch import pipeline

        if quant not in self.decoders:
            self.decoders.clear()
            free_engine()
            self.decoders[quant] = pipeline.build_random_engine(device="cuda", quant=quant,
                                                                seed=0)
        return self.decoders[quant]

    def check_align(self, label, quant, name, a, i, exact):
        """The world's probe of its own latents against the one-process
        engine's probe of the same latents: bit for bit at tp 1, else the map
        within TP_MAP_ATOL and the score within TP_SCORE_RTOL."""
        import numpy as np
        from acestep_tpu_torch import alignment, pipeline
        from acestep_tpu_torch.constants import LATENT_RATE

        dec = self.one_process(quant)
        ref_map, n = dec.lyric_attention_map(a[f"{i}/{name}/latents"],
                                             pipeline.GenerationRequest(**self.requests[name]))
        ref_stamps = alignment.token_timestamps(ref_map, n,
                                                dec.dit_cfg.patch_size / LATENT_RATE)
        ref_score = alignment.alignment_score(ref_map, n)
        got, stamps = a[f"{i}/{name}/align_map"], a[f"{i}/{name}/align_stamps"]
        score = float(a[f"{i}/{name}/align_score"])
        err = float(np.abs(got - ref_map).max())
        rel = abs(score - ref_score) / abs(ref_score)
        log(f"  {label} alignment probe of {n} lyric tokens: map [{got.shape[0]}, "
            f"{got.shape[1]}] within {err:.3e} of the one process's probe of these latents "
            f"(peak {float(ref_map.max()):.3e}), score {score:.6f} / {ref_score:.6f} "
            f"(rel {rel:.2e}), stamps: {int((stamps == ref_stamps).sum())} of {n} equal, "
            f"at most {float(np.abs(stamps - ref_stamps).max()):.2f} s apart; held "
            + ("bit for bit" if exact else f"map <= {TP_MAP_ATOL}, score <= {TP_SCORE_RTOL}"))
        if exact:
            require(np.array_equal(got, ref_map) and np.array_equal(stamps, ref_stamps)
                    and score == ref_score,
                    f"phase tp: {label} alignment probe differs from the one process's")
        else:
            require(err <= TP_MAP_ATOL and rel <= TP_SCORE_RTOL,
                    f"phase tp: {label} alignment probe outside the CPU tests' bounds")

    def check_train(self, label, run, a, i, exact):
        """The world's tree after two steps against the one process's: bit for
        bit at one rank, else the update within TP_UPDATE_TOL and each loss
        within TP_LOSS_RTOL."""
        losses, ref = [float(x) for x in a[f"{i}/train/losses"]], run["ref_losses"]
        log(f"  {label} train: steps " + ", ".join(f"{x:.3f}" for x in run["step_s"])
            + f" s (the first a warm-up, the third timed only), count {run['count']}; losses "
            f"{losses} against the one process's {ref}; leaves bit-equal {run['equal_leaves']} "
            f"of {run['leaves']}; the update {run['update_rel']:.3e} of the one process's "
            f"(norm per leaf, the largest: {run['worst_leaf'] or 'none'}); held "
            + ("bit for bit" if exact else f"update <= {TP_UPDATE_TOL:.4f}, losses <= "
                                           f"{TP_LOSS_RTOL}"))
        require(run["count"] == 2, f"phase tp: {label} train: count {run['count']}")
        if exact:
            require(run["equal_leaves"] == run["leaves"] and losses == ref,
                    f"phase tp: {label} train step differs from the one process's")
        else:
            require(run["update_rel"] <= TP_UPDATE_TOL and all(
                abs(x - r) <= TP_LOSS_RTOL * abs(r) for x, r in zip(losses, ref)),
                f"phase tp: {label} train step outside the CPU tests' bounds")

    def gate_pair(self, label, quant, got_lat, got_audio, ref):
        """The latents against the single-process engine's, and the waveform
        against the single-process engine's decode of these latents, both at
        the Q8_0 gate.  The waveform against the single-process waveform is
        held to a witness: the single-process latents plus white noise of the
        power of the world's latent difference, decoded by the single-process
        engine (TP_WITNESS_DRAWS draws), show how far the random decoder moves
        the waveform for such a difference alone; the world's waveform SNR
        must be at least the lowest draw's less TP_WITNESS_MARGIN_DB."""
        import numpy as np

        dec = self.one_process(quant)
        mine = engine_decode(dec, got_lat)
        for what, g, r in (("latents", got_lat, ref.latents), ("waveform", got_audio, mine)):
            cos, snr = gate(r.astype(np.float64), g.astype(np.float64))
            log(f"  {label} {what}: cosine {cos:.6f}, SNR {snr:.2f} dB (held: >= 0.999, >= 26)")
            require(cos >= 0.999 and snr >= 26.0,
                    f"phase tp: {label} {what} outside the Q8_0 gate")
        sigma = float(np.sqrt(np.mean((got_lat.astype(np.float64)
                                       - ref.latents.astype(np.float64)) ** 2)))
        wit = []
        for seed in range(TP_WITNESS_DRAWS):
            noise = np.random.default_rng(seed).standard_normal(ref.latents.shape) * sigma
            noisy = (ref.latents.astype(np.float64) + noise).astype(ref.latents.dtype)
            wit.append(gate(ref.audio_i16.astype(np.float64),
                            engine_decode(dec, noisy).astype(np.float64))[1])
        _, lat_snr = gate(ref.latents.astype(np.float64), got_lat.astype(np.float64))
        cos, snr = gate(ref.audio_i16.astype(np.float64), got_audio.astype(np.float64))
        floor = min(wit) - TP_WITNESS_MARGIN_DB
        log(f"  {label} waveform vs the single-process waveform: cosine {cos:.6f}, SNR "
            f"{snr:.2f} dB; witness (one process, its latents plus white noise at the "
            f"world's {lat_snr:.2f} dB, decoded): SNR "
            + ", ".join(f"{w:.2f}" for w in wit) + f" dB (held: >= {floor:.2f})")
        require(snr >= floor, f"phase tp: {label} waveform {snr:.2f} dB from the "
                f"single-process waveform, below the witness's {min(wit):.2f} dB less "
                f"{TP_WITNESS_MARGIN_DB} dB")

    def account(self, label, metas):
        """Each rank's seconds and peak memory; each run's launches (every
        kernel of its path launched) and every new shape held to its plain
        version."""
        attn, fused = decode_attn_names()
        for i, m in enumerate(metas):
            log(f"  world {label} rank {i}: {m['seconds']:.1f} s (init {m['init_s']:.1f} s), "
                f"peak device memory {m['peak_gib']:.2f} GiB")
        for j, job in metas[0].items():
            for name, run in (job.items() if isinstance(job, dict) else ()):
                if not isinstance(run, dict):
                    continue
                log(f"  world {label} job {j} {name}: {run['seconds']:.2f} s; launches "
                    + json.dumps({k: v for k, v in run["launches"].items() if v}))
                for k in self.need[name]:
                    require(run["launches"][k] > 0,
                            f"phase tp: world {label} {name} did not launch {k}")
                for r in metas:
                    for k, v in r[j][name]["launches"].items():
                        self.launched[k] = self.launched.get(k, 0) + v
                shapes = {k: {tuple(s) if isinstance(s, list) else s: n for s, n in by}
                          for k, by in run["shapes"].items()}
                self.recheck_shapes(shapes, 1234)
                for shape in shapes[attn]:
                    self.check_attn_shape(shape, False)
                for shape in shapes[fused]:
                    self.check_attn_shape(shape, True)

    def world(self, label, backend, devices, jobs, tag, exact=False):
        """Run one world, check that every rank's outputs agree, account it and
        hold each job's outputs to the single-process references (``exact``:
        the probe and the train step bit for bit)."""
        import numpy as np

        t = time.perf_counter()
        arrays, metas = tp_world(label, backend, devices, jobs, os.path.join(self.work, tag))
        log(f"  world {label}: {time.perf_counter() - t:.1f} s")
        tp_same_on_every_rank(label, arrays)
        self.account(label, metas)
        a = arrays[0]
        for i, job in enumerate(jobs):
            mesh_tag = "x".join(map(str, job["mesh"]))
            if job["kind"] == "train":
                self.check_train(f"({mesh_tag})", metas[0][str(i)]["train"], a, i, exact)
                continue
            if job["kind"] == "engine":
                for name in job["requests"]:
                    self.gate_pair(f"({mesh_tag}) {job['quant']} {name}", job["quant"],
                                   a[f"{i}/{name}/latents"], a[f"{i}/{name}/audio"],
                                   self.refs[name])
                for name in job.get("align", ()):
                    self.check_align(f"({mesh_tag}) {job['quant']} {name}", job["quant"],
                                     name, a, i, exact)
                if job.get("batcher"):
                    served = [m[str(i)]["batcher"]["batches"] for m in metas]
                    same = all(np.array_equal(a[f"{i}/batcher/{k}"], a[f"{i}/b2/{k}"])
                               for k in ("latents", "audio"))
                    log(f"  ({mesh_tag}) rank 0's batcher: {len(job['batcher'])} requests in "
                        f"{served[0]} merged batch, served by the ranks {served} times; "
                        "latents and int16 " + ("equal" if same else "NOT equal")
                        + " to the meshed batch of two bit for bit")
                    require(served == [1] * len(metas) and same,
                            f"phase tp: ({mesh_tag}) rank 0's batcher: batches {served}, "
                            "or its result differs from the meshed batch of two")
                continue
            for mode in job["modes"]:
                self.lm_tokens(f"({mesh_tag}) planner codes, decode_attn={mode}",
                               a[f"{i}/{mode}/tokens"][0], *self.lm_ref[mode])
        return arrays

    def lm_tokens(self, label, got, ref_toks, gaps):
        """Greedy tokens equal to the single-process run's until a step whose
        top-1 / top-2 gap (over the allowed logits' peak) is below check_mega's
        drift: the first token that differs must be at such a close call
        (after it the two runs decode different sequences)."""
        close = [s for s, g in enumerate(gaps) if g < self.mega_drift]
        equal = next((s for s in range(len(got)) if got[s] != ref_toks[s]), len(got))
        log(f"  {label}: {equal} of {len(got)} greedy tokens equal the single-process run; "
            f"{len(close)} of its steps are close calls (gap below check_mega's drift "
            f"{self.mega_drift:.3e} of the peak"
            + (f", the first at step {close[0]})" if close else ")")
            + (f"; the first differing step's gap {gaps[equal]:.3e}" if equal < len(got)
               else ""))
        if equal < len(got):
            require(gaps[equal] < self.mega_drift,
                    f"phase tp: {label}: token {equal} differs where the single-process "
                    f"margin {gaps[equal]:.3e} is above the drift")

    def world_one(self):
        """World 1 over NCCL: the bootstrap and the group code at tp 1, equal
        to the single-process engine bit for bit."""
        import numpy as np

        arrays = self.world("1 (nccl)", "nccl", ["cuda:0"],
                            [self.engine_job((1, 1), "q8_0", "10s", align=True),
                             self.train_job((1, 1))], "w1", exact=True)
        ref = self.refs["10s"]
        require(np.array_equal(arrays[0]["0/10s/latents"], ref.latents)
                and np.array_equal(arrays[0]["0/10s/audio"], ref.audio_i16),
                "phase tp: world 1 over NCCL differs from the single-process engine")
        log("  world 1 (nccl): latents and int16 equal the single-process engine's bit for bit")

    def gloo_worlds(self):
        """Worlds 2 and 4 over gloo, every rank on cuda:0."""
        self.world("2 (gloo on cuda:0)", "gloo", ["cuda:0"] * 2,
                   [self.engine_job((1, 2), "q8_0", "10s", align=True),
                    self.engine_job((1, 2), "q4_k", "60s"), self.lm_job((1, 2)),
                    self.train_job((1, 2))], "w2")
        self.world("4 (gloo on cuda:0)", "gloo", ["cuda:0"] * 4,
                   [self.engine_job((1, 4), "q8_0", "10s", align=True),
                    self.engine_job((2, 2), "q8_0", "b2", batcher=True), self.lm_job((1, 4)),
                    self.train_job((2, 2))], "w4")

    def card_world(self, n):
        """NCCL over ``n`` cards, one a rank: the 10 s request at (1, n) with
        its alignment probe, the planner at tp n, the train job at (1, n), and
        at four cards the batch of two at (2, 2) beside rank 0's batcher and
        the train job at (2, 2) instead."""
        jobs = [self.engine_job((1, n), "q8_0", "10s", align=True), self.lm_job((1, n))]
        if n == 4:
            jobs.append(self.engine_job((2, 2), "q8_0", "b2", batcher=True))
        jobs.append(self.train_job((2, 2) if n == 4 else (1, n)))
        self.world(f"{n} (nccl, a card a rank)", "nccl", [f"cuda:{r}" for r in range(n)],
                   jobs, f"n{n}")

    def run(self):
        import torch
        from acestep_tpu_torch.parallel import mesh as pmesh

        free_engine()
        free, total = torch.cuda.mem_get_info()
        log(f"device memory free before the worlds: {free / 2**30:.1f} of "
            f"{total / 2**30:.1f} GiB")
        self.world_one()
        self.gloo_worlds()
        if torch.cuda.device_count() >= 2:
            self.card_world(min(torch.cuda.device_count(), 4))
        else:
            log("  NCCL at a world of 2 or more needs a card a rank: this machine has "
                f"{torch.cuda.device_count()} card, so that world did not run")
        self.decoders.clear()
        free_engine()
        log(f"phase tp: {time.perf_counter() - self.t0:.1f} s; tier table for 1/2/4/8 "
            "devices: " + json.dumps({n: dataclasses.asdict(pmesh.tier_for(n))
                                      for n in (1, 2, 4, 8)}))
        return self.launched


def decode_attn_names():
    from acestep_tpu_torch.ops.cuda import decode_attn

    return decode_attn.ATTN.name, decode_attn.FUSED.name


def run() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from acestep_tpu_torch import loader, pipeline, sampler, weights
        from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
        from acestep_tpu_torch.ops.cuda import _build, dit_mega, qmm, qmm_int8
        from acestep_tpu_torch.ops.cuda import vae_resunit as vru
        from acestep_tpu_torch.serving import launch
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"card: {smi_line}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase("build")
    t = time.perf_counter()
    _build.lib()
    log(f"kernels built in {time.perf_counter() - t:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}) "
        f"-> {_build.library_path()}")

    dit_cfg, text_cfg, vae_cfg = DiTConfig(), QwenConfig(), VAEConfig()
    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    unit, trio = vru.UNIT.name, vru.TRIO.name
    phase("check")
    checked = {name: set() for name in list(names.values()) + [unit, trio]}
    errs = {name: 0.0 for name in checked}

    def qcheck(fmt, shape, seed):
        errs[names[fmt]] = max(errs[names[fmt]], check_qmm(fmt, shape, seed))
        checked[names[fmt]].add(shape)

    def recheck_shapes(shapes, seed, lm=None):
        """Every (kernel, shape) in ``shapes`` (by kernel name) not checked yet,
        against its plain version as phase check holds it: the dequant
        matmuls, the res unit and trio, and row 11 where ``lm`` (its layers,
        config and check_mega's bounds at that depth) is given."""
        for fmt, name in names.items():
            for shape in shapes[name]:
                if shape not in checked[name]:
                    qcheck(fmt, shape, seed)
        for name, check in ((unit, check_unit), (trio, check_trio)):
            for shape in shapes[name]:
                if shape not in checked[name]:
                    errs[name] = max(errs[name], check(shape, seed))
                    checked[name].add(shape)
        if lm is not None:
            for shape in shapes[mega_name]:
                if shape not in checked[mega_name]:
                    errs[mega_name] = max(errs[mega_name], check_mega_shape(*lm, shape, seed))
                    checked[mega_name].add(shape)
            log(f"  {mega_name} launches by (B, T): " + json.dumps(
                {str(k): v for k, v in sorted(shapes[mega_name].items())})
                + " (each (B, T) held to the plain version)")

    # ragged M, N and K (K % 128: 96, 32, 64; K = 384: the 60 s proj_in)
    for i, shape in enumerate(main_path_shapes(dit_cfg, text_cfg) +
                              [(77, 2048, 200), (1, 96, 64), (129, 6144, 2048),
                               (768, 384, 2048), (16, 160, 2048), (3, 320, 1000)]):
        qcheck("q8_0", shape, i)
    shapes60 = main_path_shapes(dit_cfg, text_cfg, frames=1536)
    # the decoder shapes of configs[2]'s 120 s bucket (M = 1536) for the 4-bit kernels
    decoder120 = [s for s in main_path_shapes(dit_cfg, text_cfg, frames=3072)
                  if s[0] == 3072 // dit_cfg.patch_size and s[1] % 256 == 0]
    for fmt in FOUR_BIT:
        by_kernel = shapes_by_kernel(fmt, shapes60)
        for kfmt, shapes in sorted(by_kernel.items()):
            extra = [(77, 2048, 200), (5, 512, 40)] + decoder120 if kfmt == fmt else []
            for i, shape in enumerate(shapes + extra):
                if shape not in checked[names[kfmt]]:
                    qcheck(kfmt, shape, 1000 + i)
    frames = 250       # latent frames of the 10 s clip the decoder sees
    up = vae_cfg.upsampling_ratios
    l256 = frames * up[0] * up[1] * up[2]
    for d in (1, 3, 9):
        for shape in ((1, l256, 256, d), (2, 45, 256, d), (1, 20, 256, d)):
            errs[unit] = max(errs[unit], check_unit(shape, d))
            checked[unit].add(shape)
    trio10 = ((1, l256 * up[3], 128), (1, l256 * up[3] * up[4], 128))
    for shape in trio10 + ((2, 70, 128), (2, 45, 128), (1, 20, 128)):
        errs[trio] = max(errs[trio], check_trio(shape, 7))
        checked[trio].add(shape)
    for d in (1, 3, 9):
        res_fault_rejected("unit", (1, l256, 256, d), 40 + d)
    for shape in trio10:
        res_fault_rejected("trio", shape, 50)
    int8_name, dit_name = qmm_int8.INT8.name, dit_mega.MEGA.name
    errs[int8_name] = 0.0
    lm_h, lm_i = 1024, 3072                 # the 0.6B planner: (K, N) of its q8_0 linears
    int8_shapes = [(m, k, n) for m in (1, 2, 4, 8, 16)
                   for k, n in ((lm_h, 4096), (2048, lm_h), (lm_h, 2 * lm_i), (lm_i, lm_h),
                                (lm_h, 65536))]
    h = dit_cfg.hidden_size
    int8_shapes += [(1, 256, h), (1, h, h), (1, h, 6 * h)]       # the DiT timestep linears
    for i, shape in enumerate(int8_shapes):
        errs[int8_name] = max(errs[int8_name], check_int8(shape, 500 + i))
    check_int8_stacked(560)
    ragged = QmmCase("q8_0", 4, 512, 200, 599)
    n_int8, n_q8 = qmm_int8.INT8.launches, qmm.KERNELS["q8_0"].launches
    qmm.qmm_nd(ragged.x, ragged.qt, int8_act=True)
    require(qmm_int8.INT8.launches == n_int8 and qmm.KERNELS["q8_0"].launches == n_q8 + 1,
            "N % 128 != 0 with int8_act did not take the q8_0 kernel")
    log("  int8_act at N = 200 took the q8_0 kernel, as the JAX fallback does")

    phase("check_dit")
    errs[dit_name] = check_dit_mega(dit_cfg)
    free_engine()

    phase("engine")
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q8_0", seed=0)
    torch.cuda.synchronize()
    log(f"full-width q8_0 engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    phase("serve")
    rng = np.random.default_rng(0)
    style, lyric = rng.integers(0, 150000, (1, 64)), rng.integers(0, 150000, (1, 256))
    req = pipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                     lyric_token_ids=lyric, seeds=[1])
    path10 = [names["q8_0"], unit, trio]
    results, served = {}, {}
    results["10s"], served["10s"] = serve(engine, req, "configs[0] q8_0", 3, path10)
    # the batch-2 request that phase tp splits over dp, served here in one process
    req_b2 = dataclasses.replace(req, batch_size=2, style_token_ids=np.repeat(style, 2, 0),
                                 lyric_token_ids=np.repeat(lyric, 2, 0), seeds=[1, 2])
    results["b2"], served["b2"] = serve(engine, req_b2, "configs[0] q8_0 batch 2", 1, path10)
    # request A: 10.24 s fills its 256-frame bucket, so no self-attention mask;
    # a second engine object around the weights already on the card
    engine_a = pipeline.AceStepEngine(engine.dit_params, dit_cfg, engine.vae_params, vae_cfg,
                                      engine.text_params, text_cfg, device="cuda",
                                      dit_mega=True, int8_act=True)
    req_a = dataclasses.replace(req, duration_s=DIT_A_S)
    n_steps = len(sampler.get_timestep_schedule(req_a.shift, req_a.timesteps))
    results["A"], served["A"] = serve(
        engine_a, req_a, "request A (10.24 s, dit_mega + int8_act)", 3, path10 + [dit_name],
        exact={dit_name: n_steps, int8_name: 6 * n_steps})
    results["A off"], served["A off"] = serve(
        engine, req_a, "request A with both switches off", 2, path10,
        exact={dit_name: 0, int8_name: 0})
    la, lo = results["A"][-1].latents.ravel(), results["A off"][-1].latents.ravel()
    lat_cos = float(la.astype(np.float64) @ lo / (np.linalg.norm(la) * np.linalg.norm(lo)))
    log(f"request A latents, switches on vs off (two different functions): cosine "
        f"{lat_cos:.6f}")
    require(np.array_equal(results["A"][1].audio_i16, results["A"][2].audio_i16),
            "two runs of request A differ")
    check_audio(results["A"] + results["A off"], int(round(DIT_A_S * 25)) * vae_cfg.hop_length)

    phase("output")
    check_audio(results["10s"], 480000)
    require(np.array_equal(results["10s"][1].audio_i16, results["10s"][2].audio_i16),
            "two runs of one request differ")
    small_dit = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                          in_channels=24, audio_acoustic_hidden_dim=8, sliding_window=8,
                          text_hidden_dim=128, num_lyric_encoder_hidden_layers=1)
    small_text = QwenConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=2,
                            intermediate_size=256, head_dim=64)
    small_vae = VAEConfig(encoder_hidden_size=16, decoder_channels=128,
                          decoder_input_channels=8, downsampling_ratios=(2, 2, 2),
                          channel_multiples=(1, 2, 4))
    small_rng = np.random.default_rng(1)
    small_req = pipeline.GenerationRequest(
        duration_s=10.0, style_token_ids=small_rng.integers(0, 512, (1, 20)),
        lyric_token_ids=small_rng.integers(0, 512, (1, 40)), seeds=[2])
    noise = torch.randn((1, 256, 8), generator=torch.Generator().manual_seed(5))

    def card_vs_cpu(quant, need, cfg=small_dit, request=small_req, knobs=None, sde=False):
        knobs = knobs or {}
        draws = {}
        if sde:       # the same per-step SDE draws on both sides
            request = dataclasses.replace(request, infer_method="sde")
            draws["sde_noise"] = torch.randn((8, 1, 256, 8),
                                             generator=torch.Generator().manual_seed(6))
        cpu_eng = pipeline.build_random_engine(device="cpu", quant=quant, seed=3,
                                               dit_cfg=cfg, vae_cfg=small_vae,
                                               text_cfg=small_text, **knobs)
        gpu_eng = pipeline.AceStepEngine(
            weights.tree_to(cpu_eng.dit_params, "cuda"), cfg,
            weights.tree_to(cpu_eng.vae_params, "cuda"), small_vae,
            weights.tree_to(cpu_eng.text_params, "cuda"), small_text, device="cuda", **knobs)
        before = snapshot_counts()[0]
        ref = cpu_eng.generate(request, noise=noise, **draws).audio.ravel().astype(np.float64)
        got = gpu_eng.generate(request, noise=noise, **draws).audio.ravel().astype(np.float64)
        after = snapshot_counts()[0]
        require(all(after[n] > before[n] for n in need),
                f"small {quant} engine {knobs} on the card missed a kernel of {need}")
        cos, snr = gate(ref, got)
        what = f"{quant} engine {knobs}" + (" SDE" if sde else "")
        log(f"small {what}, card (kernels) vs CPU (plain): cosine {cos:.6f} "
            f"(>= 0.999), SNR {snr:.2f} dB (>= 26)")
        require(cos >= 0.999 and snr >= 26.0, f"card and CPU disagree on the small {what}")

    card_vs_cpu("q8_0", path10)
    card_vs_cpu("q8_0", path10, sde=True)
    # a small engine that meets the megakernel's gate (head dim 128), at 10.24 s
    mega_dit = dataclasses.replace(small_dit, num_attention_heads=4, num_key_value_heads=2,
                                   head_dim=128, sliding_window=4)
    card_vs_cpu("q8_0", [dit_name, int8_name], cfg=mega_dit,
                request=dataclasses.replace(small_req, duration_s=DIT_A_S),
                knobs=dict(dit_mega=True, int8_act=True))

    phase("engine60")
    del engine
    free_engine()
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q4_0", seed=0)
    torch.cuda.synchronize()
    memory = {"q4_0": torch.cuda.memory_allocated() / 2**30}
    log(f"full-width q4_0 engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {memory['q4_0']:.2f} GiB")

    phase("serve60")
    req60 = pipeline.GenerationRequest(duration_s=60.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1])
    results["60s q4_0"], served["60s q4_0"] = serve(
        engine, req60, "configs[1] q4_0", 3, [names["q4_0"], names["q8_0"], unit, trio])
    require(np.array_equal(results["60s q4_0"][1].audio_i16, results["60s q4_0"][2].audio_i16),
            "two runs of the 60 s request differ")
    for fmt in ("q4_k", "q6_k"):
        del engine
        free_engine()
        t = time.perf_counter()
        engine = pipeline.build_random_engine(device="cuda", quant=fmt, seed=0)
        torch.cuda.synchronize()
        memory[fmt] = torch.cuda.memory_allocated() / 2**30
        log(f"full-width {fmt} engine built on the card in {time.perf_counter() - t:.1f} s; "
            f"device memory {memory[fmt]:.2f} GiB")
        results[f"60s {fmt}"], served[f"60s {fmt}"] = serve(
            engine, req60, f"configs[1] at {fmt}", 3, [names[fmt], unit, trio])
        require(np.array_equal(results[f"60s {fmt}"][1].audio_i16,
                               results[f"60s {fmt}"][2].audio_i16),
                f"two runs of the 60 s {fmt} request differ")
    del engine
    free_engine()

    phase("output60")
    for key in ("60s q4_0", "60s q4_k", "60s q6_k"):
        check_audio(results[key], 1500 * vae_cfg.hop_length)
    for fmt in FOUR_BIT:
        card_vs_cpu(fmt, [names[fmt], unit, trio])

    phase("check_long")
    check_long_attention(dit_cfg.sliding_window)

    phase("long")
    t = time.perf_counter()
    engine = pipeline.build_random_engine(device="cuda", quant="q4_k", seed=0)
    torch.cuda.synchronize()
    memory["q4_k long"] = torch.cuda.memory_allocated() / 2**30
    log(f"full-width q4_k engine built on the card in {time.perf_counter() - t:.1f} s; "
        f"device memory {memory['q4_k long']:.2f} GiB")
    # row 4 on every decoder, encoder and text-encoder linear, row 1 where K = 384
    path_long = [names["q4_k"], names["q8_0"], unit, trio]
    for dur in LONG_S:
        key = f"{dur:g}s q4_k"
        results[key], served[key] = serve_long(engine, dur, style, lyric, path_long)

    phase("batch")
    served.update(serve_configs3(engine, path_long))
    served["configs[3] merged vs solo"] = merged_vs_solo(engine)

    phase("audio_in")
    src_wave = chord_waveform(SRC_S, 2, SRC_CHORD)
    refer_wave = chord_waveform(REFER_S, 3, REFER_CHORD)
    src60, audio_served = serve_audio_in(engine, style, lyric, src_wave, refer_wave, path_long,
                                         vae_cfg)
    served.update(audio_served)
    del engine
    free_engine()

    phase("cfg")
    engine = pipeline.build_random_engine(device="cuda", quant="q8_0", seed=0)
    req_cfg = pipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                         lyric_token_ids=lyric, seeds=[1],
                                         guidance_scale=CFG_SCALE, infer_steps=CFG_STEPS,
                                         shift=3.0)
    for key, kw in (("cfg", {}), ("cfg adg", dict(use_adg=True, cfg_interval_start=0.1,
                                                   cfg_interval_end=0.9))):
        label = f"10 s base-model CFG {CFG_SCALE:g}, {CFG_STEPS} steps" + (
            ", ADG, interval [0.1, 0.9]" if kw else "")
        results[key], served[key] = serve_peak(engine, dataclasses.replace(req_cfg, **kw), label,
                                               path10, 480000)
        log(f"{label}: q8_0_qmm launches by M (the 2B batch's decoder at M 256): " + json.dumps(
            {str(m): sum(v for (mm, _, _), v in served[key][1][names['q8_0']].items() if mm == m)
             for m in sorted({sh[0] for sh in served[key][1][names['q8_0']]})}))
    del engine
    free_engine()

    phase("output_audio")
    card_vs_cpu_audio(src_wave, refer_wave, small_dit, small_text, [names["q8_0"], unit, trio])

    phase("checkpoint")
    src = pipeline.build_random_engine(device="cuda", quant="q4_k", seed=4,
                                       dit_cfg=small_dit, vae_cfg=small_vae,
                                       text_cfg=small_text)
    before = src.generate(small_req)
    with tempfile.TemporaryDirectory(prefix="acestep_ckpt_") as ckpt:
        for name, params, cfg in (("dit", src.dit_params, small_dit),
                                  ("vae", src.vae_params, small_vae),
                                  ("text_encoder", src.text_params, small_text)):
            loader.save_params(os.path.join(ckpt, name), params)
            with open(os.path.join(ckpt, f"{name}.config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f)
        size = sum(os.path.getsize(os.path.join(ckpt, p)) for p in os.listdir(ckpt))
        launches_before = qmm.KERNELS["q4_k"].launches
        loaded, _ = launch.build_engine(ckpt, device="cuda")
        after = loaded.generate(small_req)
    require(qmm.KERNELS["q4_k"].launches > launches_before,
            "the loaded engine did not run the q4_k kernel")
    same = (np.array_equal(before.audio_i16, after.audio_i16)
            and before.audio_scale == after.audio_scale)
    log(f"q4_k checkpoint ({size} bytes) saved, read back through build_engine: int16 "
        f"output {'identical' if same else 'DIFFERENT'}")
    require(same, "the checkpoint round trip changed the output")
    del src, loaded
    free_engine()

    phase("convert")
    served["60s q4_k converted"] = convert_phase(dit_cfg, vae_cfg, text_cfg, style, lyric,
                                                 [names["q4_k"], names["q8_0"], unit, trio])

    phase("recheck")
    for key, (_, shapes) in served.items():
        recheck_shapes(shapes, 99)

    # ---- the LM planner: configs[2]'s codes phase ----
    from acestep_tpu_torch import lm_pipeline
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.ops.cuda import decode_attn, decode_mega
    from acestep_tpu_torch.serving import lm as lm_serving

    attn_name, fused_name, mega_name = (decode_attn.ATTN.name, decode_attn.FUSED.name,
                                        decode_mega.MEGA.name)
    for name in (attn_name, fused_name, mega_name):
        errs[name] = 0.0
    attn_checked = set()

    def check_attn_shape(shape, fused):
        """Row 9 or 10 at a (B, Hq, Hkv, T) a request launched, once each."""
        name = fused_name if fused else attn_name
        if (name, shape) not in attn_checked:
            errs[name] = max(errs[name], check_attn_at(shape, fused))
            attn_checked.add((name, shape))

    def check_int8_shape(shape):
        """Row 6 at an (M, K, N) a request launched, once each."""
        if shape not in int8_shapes:
            errs[int8_name] = max(errs[int8_name], check_int8(shape, 99))
            int8_shapes.append(shape)

    phase("check_lm")
    # (B, lengths, T): T = 1024 is one T block, so all its chunks share one
    # anchor; the last case puts lengths on chunk and T-block edges (and at 64)
    attn_cases = ((1, [1], LM_T), (1, [128], LM_T), (1, [777], LM_T),
                  (4, [1, 128, 700, 1408], LM_T),
                  (8, [1, 128, 129, 640, 1000, 1300, 1407, 1408], LM_T),
                  (2, [1000, 1024], 1024),
                  (8, [63, 64, 65, 127, 128, 129, 256, 257], LM_T))
    for i, (b, lengths, t_max) in enumerate(attn_cases):
        c = attn_case(b, lengths, 50 + i, t_max=t_max)
        for li in (0, 27):
            tag = f"B={b} T={t_max} lengths={lengths} layer {li}"
            errs[attn_name] = max(errs[attn_name], check_attn_pair(
                f"{attn_name} {tag}", decode_attn.decode_attention_int8_stacked(*attn_args(c, li)),
                decode_attn.decode_attention_plain(*attn_args(c, li)), False))
            errs[fused_name] = max(errs[fused_name], check_attn_pair(
                f"{fused_name} {tag}",
                decode_attn.decode_attention_fused_stacked(*fused_args(c, li)),
                decode_attn.decode_attention_fused_plain(*fused_args(c, li)), True))
        del c
    t = time.perf_counter()
    check_layers = lm_serving.fuse_serving_params(
        qwen.init_params(QWEN3_0_6B, device="cuda", seed=11, quant="q8_0"))["layers"]
    log(f"28-layer q8_0 weights for the megakernel check drawn in {time.perf_counter() - t:.1f} s")
    errs[mega_name], mega_bounds28, checked[mega_name], mega_drift28 = check_mega(
        check_layers, QWEN3_0_6B)
    del check_layers
    free_engine()

    phase("lm_engine")
    t = time.perf_counter()
    lm_params = qwen.init_params(QWEN3_0_6B, device="cuda", seed=7, quant="q8_0")
    pipe = lm_pipeline.LMPipeline(lm_params, QWEN3_0_6B, ByteTokenizer(), device="cuda")
    del lm_params
    free_engine()
    torch.cuda.synchronize()
    memory["lm 0.6B q8_0"] = torch.cuda.memory_allocated() / 2**30
    log(f"full-width 0.6B q8_0 LM (fused, quantized head, int8 KV) built on the card in "
        f"{time.perf_counter() - t:.1f} s; device memory {memory['lm 0.6B q8_0']:.2f} GiB")

    phase("lm_serve")
    base_kw = dict(thinking=False, user_metadata={"bpm": 100}, temperature=0.85, top_p=0.95,
                   cfg_scale=1.0, batch_size=1, seed=0)
    lm_runs = {}
    for i in range(3):
        lm_runs[f"default {i}"] = lm_request(
            pipe, f"configs[2] LM request {i} ({'warm-up' if i == 0 else 'timed'})",
            [mega_name, "q8_0_qmm"], base_kw)
    require(np.array_equal(lm_runs["default 1"][0].code_indices,
                           lm_runs["default 2"][0].code_indices),
            "two runs of one LM request differ")
    for mode, name in (("pallas", attn_name), ("fused", fused_name)):
        alt = lm_pipeline.LMPipeline(pipe.params, QWEN3_0_6B, ByteTokenizer(), device="cuda",
                                     decode_mega="0", decode_attn=mode)
        lm_runs[mode] = lm_request(alt, f"{LM_SCAN_S:g} s LM request, decode_mega=0 "
                                   f"decode_attn={mode}", [name, "q8_0_qmm"], base_kw,
                                   LM_SCAN_S)
        require(lm_runs[mode][1][mega_name] == 0, f"decode_mega=0 still ran {mega_name}")
    hits = pipe.prefix_cache.hits
    lm_runs["thinking"] = lm_request(
        pipe, "LM request, thinking (free CoT), cfg 2.0, batch 4", [mega_name, "q8_0_qmm"],
        dict(thinking=True, temperature=0.85, top_p=0.95, cfg_scale=2.0, batch_size=4, seed=3))
    require(len(lm_runs["thinking"][0].candidates) == 4, "batch 4 returned another count")
    require(pipe.prefix_cache.hits > hits, "phase 2 did not reuse the phase-1 prefill")
    log(f"prefix cache: {pipe.prefix_cache.hits} hits, {pipe.prefix_cache.misses} misses; "
        f"CoT {lm_runs['thinking'][0].cot_text[:60]!r}...")
    # request B: int8_act on the default path (megakernel; the head through row
    # 6) and on the layer scan (every layer linear and the head through row 6)
    for key, mode in (("B default", "auto"), ("B layer scan", "0")):
        alt = lm_pipeline.LMPipeline(pipe.params, QWEN3_0_6B, ByteTokenizer(), device="cuda",
                                     decode_mega=mode, int8_act=True)
        lm_runs[key] = lm_request(alt, f"request B, int8_act, decode_mega={mode}",
                                  [int8_name] + ([mega_name] if mode == "auto" else []), base_kw,
                                  LM_DURATION_S if mode == "auto" else LM_SCAN_S)
        log(f"request B, decode_mega={mode}: {lm_runs[key][1][int8_name]} row 6 launches by "
            f"(M, K, N): {json.dumps({str(k): v for k, v in lm_runs[key][2][int8_name].items()})}")
    require(lm_runs["B layer scan"][1][mega_name] == 0, f"decode_mega=0 still ran {mega_name}")

    phase("recheck_lm")
    lm_check = (pipe.params["layers"], QWEN3_0_6B, mega_bounds28)
    for key, (_, _, shapes) in lm_runs.items():
        recheck_shapes(shapes, 99, lm_check)
        for shape in shapes[int8_name]:
            check_int8_shape(shape)
        for name, fused in ((attn_name, False), (fused_name, True)):
            for shape in shapes[name]:
                check_attn_shape(shape, fused)

    phase("output_lm")
    small_lm = QwenConfig(hidden_size=1024, num_hidden_layers=2, num_attention_heads=16,
                          num_key_value_heads=8, intermediate_size=3072, vocab_size=4096)
    cpu_p = lm_serving.fuse_serving_params(lm_serving.ensure_quantized_head(
        qwen.init_params(small_lm, device="cpu", seed=5, quant="q8_0")))
    gpu_p = weights.tree_to(cpu_p, "cuda")
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 4096, (1, 60)))
    from acestep_tpu_torch.serving import kv_cache as kvc

    def greedy(params, dev, mega, int8, forced=None, steps=40):
        """Greedy logits of ``steps`` decode steps; ``forced`` (the CPU run's
        logits) supplies the tokens, so both sides decode the same sequence."""
        cache = kvc.init_cache(2, 1, 8, 256, 128, device=dev)
        lg, cache = lm_serving.prefill(params, small_lm, ids.to(dev),
                                       torch.tensor([60], dtype=torch.int32, device=dev), cache,
                                       int8_act=int8)
        out = [lg.float().cpu()]
        for i in range(steps):
            tok = (out[-1] if forced is None else forced[i]).argmax(-1).to(dev)
            lg, cache = lm_serving.decode_step(params, small_lm, cache, tok, decode_mega=mega,
                                               int8_act=int8)
            cache.length = cache.length + 1
            out.append(lg.float().cpu())
        return out

    # (CPU decode_mega, card decode_mega, int8_act, the kernel, its launches in 40
    # steps, the logits bound)
    for cpu_mega, gpu_mega, int8, kname, n_launch, rel_max, what in (
            ("1", "auto", False, mega_name, 40, MEGA_REL, "megakernel"),
            ("0", "0", True, int8_name, 40 * (2 * 4 + 1) + 1, INT8_LOGIT_REL,
             "layer scan, int8_act")):
        before = snapshot_counts()[0][kname]
        ref_lg = greedy(cpu_p, "cpu", cpu_mega, int8)     # the kernels' plain versions
        got_lg = greedy(gpu_p, "cuda", gpu_mega, int8, forced=ref_lg)    # the kernels
        require(snapshot_counts()[0][kname] - before == n_launch,
                f"the small LM on the card ({what}) skipped {kname}")
        compared, worst = 0, 0.0
        for step, (r, g) in enumerate(zip(ref_lg, got_lg)):
            top2 = torch.topk(r[0], 2).values
            gap = float(top2[0] - top2[1])
            rel = float((g - r).abs().max() / r.abs().max())
            worst = max(worst, rel)
            if step <= 1:
                log(f"  {what} step {step}: card vs CPU logits max err / peak {rel:.3e} "
                    f"(< {rel_max})")
                require(rel < rel_max, f"small LM logits ({what}) at step {step} disagree")
            if gap >= MEGA_REL * float(r.abs().max()):
                require(int(g.argmax()) == int(r.argmax()),
                        f"greedy token ({what}) differs at step {step}")
                compared += 1
        log(f"small LM (1024 wide, 2 layers, q8_0) greedy on the card ({what}) vs the CPU "
            f"(plain versions), both fed the CPU's tokens: the top token equal at all "
            f"{compared} of {len(ref_lg)} steps whose CPU top-1/top-2 gap is at least "
            f"{MEGA_REL} of the peak; logits max err / peak over all steps {worst:.3e}")

    phase("check_fsm")
    from acestep_tpu_torch import constrained, inference

    vocab4k = build_demo_vocab(small_lm.vocab_size)
    fsm_cfg = constrained.FSMConfig(max_caption_chars=FSM_CAPTION)
    prompt = ByteTokenizer().encode(lm_pipeline.build_formatted_prompt(LM_CAPTION, LM_LYRICS))
    for md in ({}, {"bpm": 100, "duration": 120}):
        dfa = constrained.compile_dfa(vocab4k, fsm_cfg, user_metadata=md)
        before = snapshot_counts()[0][mega_name]
        t = time.perf_counter()
        host_ids, host_text = lm_serving.generate_with_fsm(
            gpu_p, small_lm, prompt, constrained.MetadataFSM(fsm_cfg, user_metadata=md),
            vocab4k, None, temperature=0.0, max_new_tokens=256)
        t_host = time.perf_counter() - t
        t = time.perf_counter()
        dev_ids, dev_text = lm_serving.generate_with_fsm_device(
            gpu_p, small_lm, prompt, dfa, vocab4k, None, temperature=0.0, max_new_tokens=256)
        t_dev = time.perf_counter() - t
        require(snapshot_counts()[0][mega_name] > before,
                f"the constrained decode of the small LM skipped {mega_name}")
        log(f"small LM, 4096-piece demo vocabulary, user metadata {md}: DFA {dfa.n_states} "
            f"states, exception width {dfa.exc_tok.shape[1]}; greedy host FSM {len(host_ids)} "
            f"tokens in {t_host:.3f} s, device DFA {len(dev_ids)} in {t_dev:.3f} s: "
            f"{dev_text!r}")
        require(dev_ids == host_ids, f"device DFA and host FSM tokens differ for {md}")
        require(replay_ok(dev_ids, vocab4k, md, fsm_cfg),
                f"the device DFA's tokens do not replay valid through MetadataFSM for {md}")
        # the planted faults live in the tables: a caption state that is not
        # one drops the budget term, an exception table of -1 every exception
        faults = {"caption budget dropped": dataclasses.replace(
                      dfa, is_caption=np.zeros_like(dfa.is_caption)),
                  "exception table dropped": dataclasses.replace(
                      dfa, exc_tok=np.full_like(dfa.exc_tok, -1))}
        for fault, bad_dfa in faults.items():
            bad, _ = lm_serving.generate_with_fsm_device(
                gpu_p, small_lm, prompt, bad_dfa, vocab4k, None, temperature=0.0,
                max_new_tokens=256)
            caught = bad != host_ids or not replay_ok(bad, vocab4k, md, fsm_cfg)
            log(f"  planted fault {fault}: {len(bad)} tokens, "
                f"{'rejected' if caught else 'NOT rejected'}")
            require(caught, f"planted DFA fault {fault} was not rejected for {md}")
    del cpu_p, gpu_p

    phase("full")
    free_engine()
    t = time.perf_counter()
    # build_random_engine's draws, with the DiT tree (stacked, unfused) kept
    # for phase server's checkpoint
    from acestep_tpu_torch.models.random_init import RandomInit

    init = RandomInit(torch.device("cuda"), 0, "q4_k")
    dit_tree = init.dit(dit_cfg)
    engine = pipeline.AceStepEngine(dit_tree, dit_cfg, init.vae(vae_cfg), vae_cfg,
                                    init.qwen(text_cfg), text_cfg, device="cuda")
    del init
    torch.cuda.synchronize()
    log(f"full-width q4_k engine built on the card in {time.perf_counter() - t:.1f} s; with "
        f"the 0.6B LM, device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # tools/bench_full_pipeline.py's request
    full_style = np.random.default_rng(0).integers(0, 150000, (1, 64))
    full_lyric = np.random.default_rng(1).integers(0, 150000, (1, 256))
    path_full = [names["q8_0"], names["q4_k"], unit, trio, mega_name]
    n_full = pipeline.frames_for_duration(LM_DURATION_S) * vae_cfg.hop_length
    full_runs = {}

    def full_request(lm, key, label, codec_params=None, **kw):
        params = inference.GenerationParams(
            caption=LM_CAPTION, lyrics=LM_LYRICS, duration=LM_DURATION_S,
            style_token_ids=full_style, lyric_token_ids=full_lyric, **kw)
        reset_counts()
        res = inference.generate_music(engine, lm, params, codec_params=codec_params)
        counts, shapes = snapshot_counts()
        log(f"{label}: time_costs " + json.dumps({k: round(v, 6)
                                                  for k, v in res.time_costs.items()}))
        log(f"{label}: launches " + json.dumps({k: v for k, v in counts.items() if v}))
        require(all(counts[n] > 0 for n in path_full), f"{label}: a kernel of the path was "
                f"not launched (need {path_full}, got {counts})")
        c = res.lm_result.code_indices
        require(len(c) == LM_CODES and c.dtype == np.int32 and int(c.min()) >= 0
                and int(c.max()) < 64000, f"{label}: codes {len(c)} in [{c.min()}, {c.max()}]")
        check_audio([res.dit_result], n_full)
        require(res.pcm16().shape == (1, n_full, 2), f"{label}: audio {res.pcm16().shape}")
        full_runs[key] = (res, counts, shapes)
        return res

    for i in range(3):
        full_request(pipe, f"plain {i}", f"configs[2] generate_music request {i} "
                     f"({'warm-up' if i == 0 else 'timed'})", bpm=100, thinking=False)
    require(np.array_equal(full_runs["plain 1"][0].pcm16(), full_runs["plain 2"][0].pcm16()),
            "two runs of the configs[2] request differ")
    # the LM's codes as 25 Hz hints through a random codec: the request becomes
    # a cover of them (the engine's request is caught on its way in)
    from acestep_tpu_torch.models import codec

    codec_params = codec.init_arch_params("conv_v1", seed=0, device="cuda")
    caught = {}

    def catch(req, **kw):
        caught["req"] = req
        return pipeline.AceStepEngine.generate(engine, req, **kw)

    engine.generate = catch
    res = full_request(pipe, "hints", "configs[2] generate_music with LM code hints", bpm=100,
                       thinking=False, codec_params=codec_params)
    del engine.generate
    hreq, n_hint = caught["req"], pipeline.frames_for_duration(LM_DURATION_S)
    # recomputed: cuDNN may take another f32 conv algorithm, so within 1e-5 of the peak
    hints = codec.codes_to_latents(codec_params, res.lm_result.code_indices, n_hint).cpu().numpy()
    hint_err = float(np.abs(hreq.src_latents - hints).max() / np.abs(hints).max())
    require(hreq.task == "cover" and hreq.src_latents.shape == (1, n_hint, 64)
            and hint_err <= 1e-5, f"code hints: task {hreq.task}, src "
            f"{getattr(hreq.src_latents, 'shape', None)}, max err / peak {hint_err:.2e}")
    log(f"code hints: the request became a {hreq.task} of hints {hreq.src_latents.shape}, "
        f"codes_to_latents of its 600 codes (recomputed: max err / peak {hint_err:.2e})")
    # understand_audio: the 60 s source -> 300 codes -> the understanding flow
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    und = inference.understand_audio(engine, pipe, codec_params, src_wave, temperature=0.0,
                                     max_tokens=UNDERSTAND_TOKENS)
    und_s = time.perf_counter() - t
    counts, shapes = snapshot_counts()
    full_runs["understand"] = (None, counts, shapes)
    log(f"understand_audio ({SRC_S:g} s source, {UNDERSTAND_TOKENS} tokens at most): {und_s:.4f} s;"
        f" launches " + json.dumps({k: v for k, v in counts.items() if v})
        + f"; {mega_name} by (B, T) " + json.dumps({str(k): v for k, v in shapes[mega_name].items()}))
    require(counts[mega_name] > 0 and counts[trio] > 0 and "raw_output" in und,
            "understand_audio missed the encoder or the decode megakernel")
    # +think: the constrained CoT on the device DFA over the full demo vocabulary
    vocab_full = build_demo_vocab(QWEN3_0_6B.vocab_size)
    think = lm_pipeline.LMPipeline(pipe.params, QWEN3_0_6B, DemoVocabTokenizer(vocab_full),
                                   device="cuda")
    think_md = {"duration": int(LM_DURATION_S)}
    for i in range(4):
        cands = 4 if i == 3 else 1
        label = (f"configs[2] +think request {i} "
                 + ("(warm-up, DFA compile)" if i == 0 else "(timed)" if cands == 1
                    else "with lm_num_candidates=4"))
        res = full_request(think, f"think {i}", label, thinking=True, lm_num_candidates=cands)
        lm_res = res.lm_result
        require(lm_res.cot_route == "device_dfa", f"{label}: the CoT took {lm_res.cot_route}")
        require(replay_ok(lm_res.cot_ids, vocab_full, think_md, constrained.FSMConfig()),
                f"{label}: the CoT ids do not replay valid and done through MetadataFSM")
        md = res.metadata
        require(all(str(md.get(k, "")).strip() for k in ("bpm", "keyscale", "timesignature",
                                                         "language", "caption", "genres"))
                and md.get("duration") == int(LM_DURATION_S), f"{label}: metadata {md}")
        log(f"{label}: {len(lm_res.cot_ids)} CoT tokens; metadata "
            + json.dumps({k: md[k] for k in sorted(md)}))
        if cands > 1:
            require(len(res.lm_result.candidates) == 4
                    and "lm_ranking_time_cost" in res.time_costs,
                    f"{label}: no PMI ranking of 4 candidates")
    dfa, dfa_s = think.compiled_dfa(think_md)
    log(f"DFA of the {len(vocab_full)}-piece demo vocabulary: {dfa.n_states} states, exception "
        f"width {dfa.exc_tok.shape[1]}, masks {dfa.masks_packed.nbytes / 1e6:.1f} MB, compiled "
        f"in {dfa_s:.2f} s (host), once per (vocabulary, genres, user metadata)")
    # the stop test: the host reads the done flag once every N steps (16 by
    # default); N = 1 stops at once, N = 512 runs every step of the budget
    cot_prompt = think.tok.encode(lm_pipeline.build_formatted_prompt(LM_CAPTION, LM_LYRICS))
    stop = {}
    for n in (1, 16, 512, 16):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, _ = lm_serving.generate_with_fsm_device(
            think.params, QWEN3_0_6B, cot_prompt, dfa, vocab_full, None, temperature=0.0,
            max_new_tokens=512, check_every=n)
        stop.setdefault(n, []).append((time.perf_counter() - t, ids))
    require(all(ids == stop[1][0][1] for runs in stop.values() for _, ids in runs),
            "the device DFA's greedy tokens depend on how often the done flag is read")
    log(f"greedy device-DFA CoT, {len(stop[1][0][1])} tokens, s by how often the done flag is "
        "read: " + json.dumps({f"every {n} steps": [round(t, 4) for t, _ in runs]
                               for n, runs in stop.items()}))
    del think

    phase("planners")
    launched_planners = planners_phase(engine, full_style, full_lyric, recheck_shapes,
                                       check_int8_shape, check_attn_shape, mega_bounds28[0])

    phase("server")
    served_http = serve_http(engine, dit_tree, pipe, src_wave, refer_wave, names, mega_name,
                             audio_small_cfgs(small_dit) + (small_text,))

    phase("train")
    work_train = tempfile.TemporaryDirectory(prefix="acestep_train_")
    train_tree, train_stats = train_full_width(dit_cfg, work_train.name)

    phase("train_check")
    train_card_vs_cpu(small_dit)
    served_bwd = res_backward_checks(vae_cfg)

    phase("train_server")
    served_train, train_secs = train_server(engine, dit_tree, train_tree, dit_cfg,
                                            work_train.name)
    del engine, dit_tree, train_tree
    free_engine()

    phase("cli")
    cli_run(work_train.name)
    work_train.cleanup()

    phase("recheck_full")
    for key, (_, _, shapes) in full_runs.items():
        recheck_shapes(shapes, 98, lm_check)
    for key, (_, shapes) in served_http.items():
        recheck_shapes(shapes, 97, lm_check)
    for key, (_, shapes) in served_train.items():
        recheck_shapes(shapes, 96, lm_check)

    phase("timing")
    import torch.nn.functional as F

    def conv_lib(x, tens, d):
        xt = x.transpose(1, 2)
        y = F.conv1d(xt, tens[0].permute(2, 1, 0), tens[1], padding=3 * d, dilation=d)
        return F.conv1d(y, tens[2].t()[:, :, None], tens[3])

    def time_qmm(fmt, counts):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0,
               "graph": 0.0, "lib_graph": 0.0}
        for i, (shape, cnt) in enumerate(sorted(counts.items())):
            case = QmmCase(fmt, *shape, 200 + i)

            def kern():
                return qmm._launch(case.x, case.qt, None, torch.bfloat16)

            def lib_call():
                return torch.matmul(case.x, case.wd)

            ms = cuda_ms(kern)
            plain = cuda_ms(lambda: qmm.qmm_plain(case.x, case.qt))
            lib = cuda_ms(lib_call)
            b, by = case.bound()
            # device time alone (the eager time above includes the wrapper's host
            # cost where the device is faster), and the rate
            g, lg = graph_ms(kern), graph_ms(lib_call)
            tot["graph"] += cnt * g
            tot["lib_graph"] += cnt * lg
            extra = (f"; CUDA graph: kernel {g:.4f} ms "
                     f"({2.0 * shape[0] * shape[1] * shape[2] / g / 1e9:.1f} TFLOP/s), "
                     f"library {lg:.4f}")
            log(f"  {names[fmt]} M={shape[0]} K={shape[1]} N={shape[2]} x{cnt}/request: "
                f"kernel {ms:.4f} ms, plain {plain:.4f}, library {lib:.4f}, "
                f"bound {b:.4f} ({by}){extra}")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        return tot

    def time_res(kind, counts):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0,
               "bound_f32": 0.0}
        for shape, cnt in sorted(counts.items()):
            n, length, c = shape[:3]
            x = _res_x(n, length, c, 300)
            if kind == unit:
                d = shape[3]
                ops = vru.unit_operands(_unit_params(c, 300), x.device)
                ms = cuda_ms(lambda: vru.launch_unit(x, ops, d))
                plain = cuda_ms(lambda: vru.res_unit_plain(x, *ops.plain, d))
                lib = cuda_ms(lambda: conv_lib(x, ops.plain, d))
                (b, by), b32 = res_bound(n, length, c, 1)
            else:
                ops = vru.trio_operands(tuple(_unit_params(c, 300 + j) for j in range(3)),
                                        x.device)
                per = [tuple(t[j] for t in ops.plain) for j in range(3)]
                ms = cuda_ms(lambda: vru.launch_trio(x, ops))
                plain = cuda_ms(lambda: vru.res_trio_plain(x, *ops.plain))
                lib = cuda_ms(lambda: [conv_lib(x, per[j], vru.TRIO_D[j]) for j in range(3)])
                (b, by), b32 = res_bound(n, length, c, 3)
            flops = (3 if kind == trio else 1) * 16.0 * n * length * c * c
            log(f"  {kind} {shape} x{cnt}/request: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f}, library (cuDNN "
                f"convs) {lib:.4f}, bound {b:.4f} ({by}, 3xTF32), f32 CUDA-core bound "
                f"{b32:.4f}")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b),
                           ("bound_f32", b32)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        return tot

    def timed(name, path, counts=None):
        log(f"{name} on the {path} path:")
        counts = served[path][1][name] if counts is None else counts
        fmt = next((f for f, n in names.items() if n == name), None)
        tot = time_qmm(fmt, counts) if fmt else time_res(name, counts)
        log(f"{name} per {path} request: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain']:.4f}, library {tot['lib']:.4f}, bound {tot['bound']:.4f}"
            + (f"; CUDA graph: kernel {tot['graph']:.4f} ms, library {tot['lib_graph']:.4f}"
               if tot.get("graph") else "")
            + (f"; f32 CUDA-core bound {tot['bound_f32']:.4f}" if "bound_f32" in tot else ""))
        return tot

    # each kernel's row from the path that introduced it; the other paths' totals
    # are logged for the phase split
    rows = []
    row_paths = ((names["q8_0"], "10s", qmm.KERNELS["q8_0"].source,
                  qmm.KERNELS["q8_0"].replaces),
                 (unit, "10s", vru.SOURCE, vru.UNIT.replaces),
                 (trio, "10s", vru.SOURCE, vru.TRIO.replaces))
    row_paths += tuple((names[fmt], f"60s {fmt}", qmm.KERNELS[fmt].source,
                        qmm.KERNELS[fmt].replaces) for fmt in FOUR_BIT)
    for name, path, source, replaces in row_paths:
        tot = timed(name, path)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": served[path][0][name],
                     "max_abs_err": errs[name], "ms": tot["ms"], "plain_ms": tot["plain"],
                     "bound_ms": tot["bound"],
                     "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                     "library_ms": tot["lib"]})
    for name in (names["q8_0"], unit, trio):
        timed(name, "60s q4_0")
    for name in (names["q4_k"], unit, trio):
        timed(name, "600s q4_k")
    # the encoder's share of rows 7-8: one 60 s source (24 windows)
    for name in (unit, trio):
        timed(name, "encode 60s")
    # rows 7-8 in the dataset build (two samples, 20 s and 30 s) and their
    # launches in the backward check beside the main path's
    served["dataset build"] = served_train["dataset build"]
    for row in rows:
        if row["name"] in (unit, trio):
            tot = timed(row["name"], "dataset build")
            row["launches_per_dataset_sample"] = served["dataset build"][0][row["name"]] / 2
            row["ms_per_dataset_sample"] = tot["ms"] / 2
            row["launches_backward_check"] = served_bwd[0][row["name"]]
    # the q8_0 kernel on the shapes the LM requests launched (prefill, codes head,
    # layer-scan linears), weighted by their launches
    for key in ("default 2", "pallas"):
        timed(names["q8_0"], f"LM '{key}'", lm_runs[key][2][names["q8_0"]])

    # LM rows: each launch of a request timed at three valid lengths of the
    # codes phase (its first, middle and last step) and weighted by the
    # request's launches; the bound sums every step's own length
    l0 = len(ByteTokenizer().encode(lm_pipeline.build_formatted_prompt_with_cot(
        LM_CAPTION, LM_LYRICS, lm_pipeline.metadata_to_cot({"bpm": 100}))))

    def codes_steps(n_codes):
        """Valid lengths of a codes phase's decode steps, and three to time."""
        st = [l0 + i for i in range(lm_pipeline.code_bucket(n_codes + 2) - 1)]
        return st, (st[0], st[len(st) // 2], st[-1])

    steps, probe = codes_steps(LM_CODES)                 # row 11: the 120 s requests
    scan_steps, scan_probe = codes_steps(int(LM_SCAN_S * 5))     # rows 9-10: 30 s

    for name, mode, fused in ((attn_name, "pallas", False), (fused_name, "fused", True)):
        n_launch = lm_runs[mode][1][name]
        per = {"ms": [], "plain": [], "lib": [], "dev": [], "lib_dev": []}
        fn = (decode_attn.decode_attention_fused_stacked if fused
              else decode_attn.decode_attention_int8_stacked)
        plain = (decode_attn.decode_attention_fused_plain if fused
                 else decode_attn.decode_attention_plain)
        for n in scan_probe:
            c = attn_case(1, [n], 300)
            a = fused_args(c, 0) if fused else attn_args(c, 0)
            lib = sdpa_lib(c, 0, n)
            # a request's 21476 launches run on one plan of the wrapper (cache
            # checks, scratch, outputs made POOL at a time): make it and its first
            # pool before the timed calls, as a request's first steps do, and time
            # POOL calls, which make one pool as a request does every POOL calls
            for _ in range(decode_attn.POOL + 1):
                fn(*a)
            per["ms"].append(cuda_ms(lambda: fn(*a), iters=decode_attn.POOL))
            per["plain"].append(cuda_ms(lambda: plain(*a), iters=10))
            per["lib"].append(cuda_ms(lib, iters=decode_attn.POOL))
            # device time alone (CUDA graphs): the eager times above include the
            # host's cost of each call where the device is faster
            per["dev"].append(graph_ms(lambda: fn(*a)))
            per["lib_dev"].append(graph_ms(lib))
            b_ms = attn_bound(1, n, fused)[0]
            log(f"  {name} B=1 T={LM_T} length {n}: kernel {per['ms'][-1] * 1e3:.2f} us a "
                f"launch eager, {per['dev'][-1] * 1e3:.2f} us device; library (SDPA, "
                f"dequantization excluded) {per['lib'][-1] * 1e3:.2f} us eager, "
                f"{per['lib_dev'][-1] * 1e3:.2f} us device; plain {per['plain'][-1]:.4f} ms; "
                f"bound {b_ms * 1e3:.3f} us (device / bound {per['dev'][-1] / b_ms:.1f})")
        per_step = n_launch / len(scan_steps)     # one launch per layer per step
        bound = sum(attn_bound(1, n, fused)[0] for n in scan_steps) * per_step
        by = attn_bound(1, scan_steps[len(scan_steps) // 2], fused)[1]
        mean = {k: sum(v) / len(v) for k, v in per.items()}
        rows.append({"name": name, "route": "cuda", "source": decode_attn.SOURCE,
                     "replaces": (decode_attn.FUSED if fused else decode_attn.ATTN).replaces,
                     "launches": n_launch, "max_abs_err": errs[name],
                     "ms": mean["ms"] * n_launch, "plain_ms": mean["plain"] * n_launch,
                     "bound_ms": bound, "bound_by": by, "library_ms": mean["lib"] * n_launch})
        log(f"{name} per decode_attn={mode} request ({n_launch} launches): kernel "
            f"{rows[-1]['ms']:.3f} ms, plain {rows[-1]['plain_ms']:.3f}, library "
            f"{rows[-1]['library_ms']:.3f}, bound {bound:.3f}; device time alone: kernel "
            f"{mean['dev'] * n_launch:.3f} ms, library {mean['lib_dev'] * n_launch:.3f}")
    n_launch = lm_runs["default 2"][1][mega_name]
    layers = pipe.params["layers"]
    per = {"ms": [], "plain": []}
    for n in probe:
        args = mega_case(layers, 1, [n], 400)
        per["ms"].append(cuda_ms(lambda: decode_mega.decode_layers_mega(layers, QWEN3_0_6B,
                                                                        *args), iters=50))
        per["plain"].append(cuda_ms(lambda: decode_mega.decode_layers_mega_plain(
            layers, QWEN3_0_6B, *args), iters=3))
        stamps = torch.zeros(2 + len(decode_mega.STAGES) * QWEN3_0_6B.num_hidden_layers,
                             dtype=torch.int64, device="cuda")
        decode_mega.decode_layers_mega(layers, QWEN3_0_6B, *args, stamps=stamps)
        split = decode_mega.stage_times(stamps, QWEN3_0_6B.num_hidden_layers)
        log(f"  {mega_name} B=1 T={LM_T} length {n}: kernel {per['ms'][-1]:.4f} ms, plain "
            f"{per['plain'][-1]:.4f}, bound {mega_bound(QWEN3_0_6B, 1, [n])[0]:.4f}; by stage "
            "(block 0's clock at the end of each of its stages, ms summed over the layers): "
            + json.dumps({k: round(v, 4) for k, v in split.items()}))
    bound = sum(mega_bound(QWEN3_0_6B, 1, [n])[0] for n in steps) * n_launch / len(steps)
    mean = {k: sum(v) / len(v) for k, v in per.items()}
    rows.append({"name": mega_name, "route": "cuda", "source": decode_mega.MEGA.source,
                 "replaces": decode_mega.MEGA.replaces, "launches": n_launch,
                 "max_abs_err": errs[mega_name], "ms": mean["ms"] * n_launch,
                 "plain_ms": mean["plain"] * n_launch, "bound_ms": bound,
                 "bound_by": mega_bound(QWEN3_0_6B, 1, [steps[0]])[1], "library_ms": None})
    log(f"{mega_name} per configs[2] LM request ({n_launch} launches): kernel "
        f"{rows[-1]['ms']:.3f} ms, plain {rows[-1]['plain_ms']:.3f}, bound {bound:.3f} "
        f"({rows[-1]['bound_by']}); no single library call computes a decode step")

    # row 6: each launch shape of a request timed alone, weighted by its launches;
    # the row is request B's default path (the codes head), the other paths logged
    def time_int8(label, counts):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "bytes": 0.0, "ops": 0.0,
               "dev": 0.0, "lib_dev": 0.0}
        for i, (shape, cnt) in enumerate(sorted(counts.items())):
            case = QmmCase("q8_0", *shape, 700 + i)
            def kern():
                return qmm_int8._launch(case.x, case.qt)

            def lib_call():
                return torch.matmul(case.x, case.wd)

            ms = cuda_ms(kern, iters=20)
            plain = cuda_ms(lambda: qmm_int8.qmm_int8_act_plain(case.x, case.qt), iters=3)
            lib = cuda_ms(lib_call, iters=20)
            # device time alone (CUDA graphs): the eager times include the
            # wrapper's host cost where the device is faster
            dev, lib_dev = graph_ms(kern), graph_ms(lib_call)
            b, by = int8_bound(*shape)
            log(f"  {int8_name} M={shape[0]} K={shape[1]} N={shape[2]} x{cnt}/request: kernel "
                f"{ms:.4f} ms, plain {plain:.4f}, library (matmul on the dequantized bf16 "
                f"weight) {lib:.4f}, bound {b:.4f} ({by}); CUDA graph: kernel {dev:.4f} ms, "
                f"library {lib_dev:.4f}")
            for key, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b),
                           ("dev", dev), ("lib_dev", lib_dev)):
                tot[key] += cnt * v
            tot["bytes" if by == "bytes" else "ops"] += cnt * b
        log(f"{int8_name} per {label} ({sum(counts.values())} launches): kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f}, library {tot['lib']:.4f}, bound "
            f"{tot['bound']:.4f}; CUDA graph: kernel {tot['dev']:.4f} ms, library "
            f"{tot['lib_dev']:.4f}")
        return tot

    time_int8("request A (DiT timestep linears)", served["A"][1][int8_name])
    time_int8("request B on the layer scan", lm_runs["B layer scan"][2][int8_name])
    tot = time_int8("request B on the default path", lm_runs["B default"][2][int8_name])
    rows.append({"name": int8_name, "route": "cuda", "source": qmm_int8.INT8.source,
                 "replaces": qmm_int8.INT8.replaces,
                 "launches": lm_runs["B default"][1][int8_name], "max_abs_err": errs[int8_name],
                 "ms": tot["ms"], "plain_ms": tot["plain"], "bound_ms": tot["bound"],
                 "bound_by": "bytes" if tot["bytes"] >= tot["ops"] else "operations",
                 "library_ms": tot["lib"]})

    # row 12 at request A's shapes on the engine's own weights, beside the
    # port's layer-path DiT step; no single library call computes the step
    from acestep_tpu_torch.models import dit as tdit
    from acestep_tpu_torch.models.random_init import RandomInit

    dparams = engine_a.dit_params
    init = RandomInit(torch.device("cuda"), 900, "q8_0")
    n_l = dit_cfg.num_hidden_layers
    for t_tok in (DIT_T2, DIT_T):
        margs = dit_mega_inputs(init, dit_cfg, n_l, t_tok, DIT_LC)
        ms = cuda_ms(lambda: dit_mega.dit_layers_mega(dparams["layers"], dit_cfg, *margs),
                     iters=10)
        b, by = dit_bound(dit_cfg, t_tok, DIT_LC)
        stamps = torch.zeros(2 + len(dit_mega.STAGES) * n_l, dtype=torch.int64, device="cuda")
        dit_mega.dit_layers_mega(dparams["layers"], dit_cfg, *margs, stamps=stamps)
        split = dit_mega.stage_times(stamps, n_l)
        log(f"  {dit_name} T={t_tok} Lc={DIT_LC} {n_l} layers: kernel {ms:.4f} ms a launch, "
            f"bound {b:.4f} ({by}); by stage (block 0's clock at the end of each of its "
            f"stages, ms summed over the layers): "
            + json.dumps({k: round(v, 4) for k, v in split.items()})
            + f"; total {sum(split.values()):.4f}")
    plain = cuda_ms(lambda: dit_mega.dit_layers_mega_plain(dparams["layers"], dit_cfg, *margs),
                    iters=2)
    hs = init.normal((1, 2 * DIT_T, dit_cfg.audio_acoustic_hidden_dim), 1.0).bfloat16()
    ctx = init.normal((1, 2 * DIT_T, dit_cfg.context_dim), 1.0).bfloat16()
    enc = tdit.compute_condition(dparams, dit_cfg,
                                 init.normal((1, DIT_LC, dit_cfg.hidden_size), 1.0).bfloat16())
    kv = tdit.compute_all_cross_kv(dparams, dit_cfg, enc)
    kv_st = tdit.stack_cross_kv(kv)
    tt = torch.full((1,), 0.5, device="cuda")
    encm = torch.ones((1, DIT_LC), dtype=torch.int32, device="cuda")
    step = {mega: cuda_ms(lambda: tdit.forward(
        dparams, dit_cfg, hs, tt, tt, ctx, kv, encoder_attn_mask=encm, dit_mega=mega,
        int8_act=mega, cross_kv_stacked=kv_st), iters=5) for mega in (True, False)}
    n_launch = served["A"][0][dit_name]
    log(f"  {dit_name} T={DIT_T} Lc={DIT_LC} {dit_cfg.num_hidden_layers} layers: kernel "
        f"{ms:.4f} ms a launch, plain {plain:.4f}, bound {b:.4f} ({by}); the whole DiT step "
        f"(dit.forward, CUDA events) {step[True]:.4f} ms with the megakernel and int8_act, "
        f"{step[False]:.4f} ms on the layer path")
    rows.append({"name": dit_name, "route": "cuda", "source": dit_mega.MEGA.source,
                 "replaces": dit_mega.MEGA.replaces, "launches": n_launch,
                 "max_abs_err": errs[dit_name], "ms": ms * n_launch,
                 "plain_ms": plain * n_launch, "bound_ms": b * n_launch, "bound_by": by,
                 "library_ms": None})
    log(f"{dit_name} per request A ({n_launch} launches): kernel {rows[-1]['ms']:.3f} ms, "
        f"plain {rows[-1]['plain_ms']:.3f}, bound {rows[-1]['bound_ms']:.3f}; the layer-path "
        f"step x {n_launch}: {step[False] * n_launch:.3f} ms")
    log("device memory of the full-width engines (GiB): "
        + json.dumps({k: round(v, 3) for k, v in memory.items()}))
    log("kernel times are per request: each served shape timed alone (CUDA events, "
        "warm L2) and weighted by its launches in one request of the named path")

    phase("tp")
    launched_tp = TpPhase(results, pipe.params, mega_drift28, recheck_shapes,
                          check_attn_shape).run()
    for row in rows:
        row["launches_planners"] = launched_planners.get(row["name"], 0)
        row["launches_tp"] = launched_tp.get(row["name"], 0)
    log("launches in phase tp's worlds (every rank, summed): "
        + json.dumps({k: v for k, v in launched_tp.items() if v}))

    phase("quality")
    launched_quality = quality_phase(names, unit, trio, smi_line, recheck_shapes)
    for row in rows:
        row["launches_quality"] = launched_quality.get(row["name"], 0)
        if row["name"] in checked:
            row["max_abs_err"] = errs[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":
        return tp_rank_main(sys.argv[2], int(sys.argv[3]))
    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        return run()
    except Failure as exc:
        log(f"FAILED in phase '{_state['phase']}': {exc}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
