#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3: the kernels alone
    python3 chip_smoke.py --bf16      # the build and phase 6b' alone
    python3 chip_smoke.py --train-bf16  # the build and phases 7a and 9c alone
    python3 chip_smoke.py --prep      # the build and phase 9d alone
    python3 chip_smoke.py --stages    # the build and phases 6c' and 6c'' alone
    python3 chip_smoke.py --pack      # the build and phase 6a alone
    python3 chip_smoke.py --dist      # the build and phase 9e alone

Phases, each of which fails the run (non-zero exit) on any error:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
   no CUDA device is a failure.
2. build: nvcc builds every kernel source of the main paths
   (bert_vits2_tpu_torch/_build.py SOURCES, sm_90a), one process per
   source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, TF32 off; max-abs-err (the MAS kernel: exact
   equality; K1's train mode, B5 and B6 against the plain version's
   autograd, with and without the hash dropout), kernel time (CUDA events)
   and device time (the profiler's kernel time), plain time and the least
   time the card could take (fp32 rate or memory rate), and the bound of
   the unit the kernel's design uses (K1, K2, B5 and B6: 3xTF32 on the
   tensor cores).
   K3 at the training step's shape, the Trainer's longest text and a long
   text, exactly; the latency of one link of each of its dependent chains
   (probes in csrc/mas.cu) and the chain bounds built from them.
3b. attention outside the tensor-core kernels' range, the path of
   csrc/banded_attn_wide.cu: each wide kernel against its plain version
   and timed; MultiHeadAttention with a head of 160 channels and one with
   a window of 5, card against CPU at inference and in fused training
   (outputs and parameter gradients), each wide kernel launched and no
   tensor-core one.
4. serving path: TTSEngine.run_prepared on 8 seeded requests at the default
   V2.3 ModelConfig with random weights from a seed; the attention and MRF
   kernels must have launched, and the waves must be finite, in [-1, 1] and
   non-empty.
5. the same request, zero noise, on the card and on the CPU (plain
   versions): equal frame counts and waves within a stated bound.
6. serving timing: audio seconds per second and per-call latency of
   run_prepared at batch 8, peak device memory, a profiler breakdown.
6a. the request pool ([pack]): the seed-7 batch of 8 through run_prepared
   with a pool (pack_requests) and without one, each wave bit-equal (under
   cuDNN's deterministic algorithms) to the per-tensor route the engine took
   before its pool (its 13 host arrays rebuilt by `per_tensor_route`),
   bytes_h2d a call (that route's, the pool's pair, 0 through a pool); PACK_PILE
   requests through run_packed: one pair shipped for the pile, K1 28 and
   K2 3 per chunk call.
6b. text in, wave out: a config.json with the V2.3 model section and a
   G_0.pth of the random model, loaded by load_tts_engine; warmup over
   batches 1 and 8 and buckets 64 and 128; infer on a JP
   and an EN sentence (ZH too when jieba imports: its g2p segments with
   jieba), infer_multilang (JP + EN) and infer_batch of 8 sentences across
   the languages. No BERT weights are in the checkout, so the extractor
   gives seeded noise with its warning. Each call must launch K1 28 times
   and K2 3 times (counts zeroed just before it); one JP sentence at zero
   noise, card against CPU; infer_batch timed over 5 calls, host time
   (prepare) split from synthesis time.
6b'. bf16 serving ([bf16]): K1's bf16 mode at the flow's [8, 2, 768, 96],
   the wide forward's at one [attention-range] shape and K2's at C = 64,
   32, 16, each against its plain bf16 version (within K1_BF16_ULPS /
   K2_BF16_ULPS bf16 ulps of the largest reference entry; the least time at
   989 TFLOP/s bf16); a bf16 MultiHeadAttention of d = 160 card against CPU
   through the wide bf16 kernel; then the [text] phase's config.json and
   G_0.pth loaded by load_tts_engine(compute_dtype="float32" and
   "bfloat16"): identical state_dicts; the seed-7 batch of 8 through
   run_prepared on both, K1 28 fp32 launches a fp32 call and 12 fp32 + 16
   bf16 a bf16 call, K2 3 fp32 or 3 bf16; y_lengths equal; the bf16 waves
   against the fp32 ones (max-abs error, log-mel L1 over every bin and over
   the bins within 60 dB of each utterance's peak); both engines timed in
   turns (F B B F), peak memory, a profile of one call each with device
   time by group (K1, K2, convs and GEMMs, the rest) and the device time of
   the C >= 128 vocoder stages' convolutions.
6c. old checkpoint versions ([versions]): for each version family of
   compat/versions.py, a config.json at the V2.3 widths (version 1.0.1,
   1.1.1, 2.0.2-fix, 2.1, 2.2, and a 2.3 one with use_transformer_flow
   false) and a reference-layout G_0.pth of a nonzero-init model (the
   V2.1/V2.2 quantizers' EMA buffers in the file), loaded by
   load_tts_engine on the card: every parameter from the file, the buffers
   dropped. JP and EN from text where the family has them (1.1: JP; 1.0 is
   ZH only and goes through run_prepared on seeded ids, since its g2p
   needs jieba); V2.1 with emotion=3 and with a stub extractor's 1024-d
   vector, V2.2 with zero features and a stub's 512-d vector. Each call
   launches K1 28 times (12 with the vits1 flow) and K2 3 times; one
   zero-noise call per emotion input card against CPU within WAVE_BOUND;
   each family's median time beside the 2.3 engine's.
6c'. the six inference stages ([stages]): make_stages over the engine's
   flow, decoder and packed MRF weights (default V2.3 widths, fp32), the
   seed-7 batch of 8 at zero noise: run_stages against Synthesizer.infer on
   the card (STAGE_BOUND, equal lengths) and the CPU (WAVE_BOUND, one
   item); K1 and K2 launches per stage (enc_p 6, flow 16, dec K2 3, nothing
   else); export_stages on the card, torch.export.load, the six programs
   run once each on the same inputs (the same launches, the live stages'
   outputs); each of the six torch.ops.bv2.* ops bit-equal to the direct
   launch of its kernel at the main path's shapes; each program's and
   live stage's time (events and device) beside utils/flops.py's FLOPs,
   run_stages through the programs and the live stages beside
   run_prepared's median.
6c''. ONNX export ([onnx]): the six graphs of the same model exported on
   the CPU (compat/onnx_export.py) at (ONNX_T_X, ONNX_FRAMES), each
   conformant to compat/onnx_check.py and, on the numpy evaluator, within
   ONNX_BOUND of the card's stage on verify_onnx's random inputs; file
   sizes and the phase's seconds.
6d. the HTTP server in process ([serve]): a ModelRegistry with the loader
   that the server's main() builds (load_tts_engine on the card) over the
   same config.json and G_0.pth, warmup over batches 1, 4 and 16 and
   buckets 64 and 128, make_server on a free port. Client threads send 32
   POST /voice requests at each concurrency level 1, 4 and 16 (JP and EN
   sentences at the server's default knobs, every eighth an auto_split
   paragraph of four sentences, one AUTO and one MIX request):
   requests/s, audio-s/s, latency p50/p95/max, the micro-batcher's batch
   sizes and device calls, peak memory, K1 = 28 and K2 = 3 launches per
   device call; the profiler's device busy share over one burst of 16 at
   concurrency 16. Checks: a zero-noise JP /voice within 1 LSB of
   float_to_int16 of engine.infer; a zero-noise auto_split paragraph of
   four sentences in one bucket rides one device call of 4, each sentence
   within WAVE_BOUND of the sentence served alone; the same paragraph with
   batching off equals the batched one; /status names the card,
   /models/info the engine's device.
6e. the server's CLI ([serve-cli]): `python -m
   bert_vits2_tpu_torch.serve.server --device cuda --warmup --model
   G_0.pth:config.json` in a subprocess on a free port; it must print its
   `serving on` line, answer GET /status and two POST /voice (the first
   also loads the EN g2p's lexicon) with a WAV of a whole number of
   frames, and is terminated.
6f. the BERT encoder (text/bert_encoder.py) at the published widths of
   chinese-roberta-wwm-ext-large and deberta-v3-large, random weights:
   ms per forward at 64 ids, peak memory, hidden_states[-3] card against
   CPU.
7. training step: build_models / init_params / init_train_state /
   make_train_step at the default V2.3 ModelConfig, fp32, batch 16 of 128
   tokens and 512 frames with ragged lengths; two warm-up and five timed
   steps with dense attention; finite metrics, one MAS kernel launch per
   step, every parameter set moved, a valid monotonic alignment; ms per
   step, peak memory, a profiler breakdown of one step; then the same
   batch and weights with the fused attention (BV2_FUSED_ATTENTION_TRAIN=1)
   and the dense one in turns: both medians and peak memories.
7a. bf16 training ([train-bf16]): K1's train mode, B5 and B6 on bf16
   operands at the flow's [16, 2, 512, 96] and a ragged [2, 2, 1001, 96],
   and the wide kernels' bf16 modes at [4, 1, 200, 160], against their
   plain bf16 versions without and with the hash dropout (BWD_BF16_ULPS
   bf16 ulps of the largest reference entry; m, l within BWD_REL_BOUND),
   timed, the least time at 989 TFLOP/s bf16 or the bytes; a bf16
   MultiHeadAttention of d = 160 in fused training card against CPU
   (the wide bf16 kernels, once each); then the default V2.3 models at
   init_params(seed=1234) twice, fp32 and train_compute_dtype "bfloat16"
   with bf16_run, on the [train] batch with fused attention: the first
   step of each from the same weights, noise and dropout seeds (launches:
   fp32 K1-train/B5/B6 22 each, bf16 6 fp32 + 16 bf16 each, K3 1; losses
   within BF16_LOSS_REL of fp32's; finite grad norms; float32 master
   parameters), steps in turns (F B B F): medians, peak memory, a profile
   of one step each with device time by group; and the bf16 training
   forward at a cut depth, zero MAS noise, card against CPU.
7b. the training step with the SLM losses ([train-slm]): a random WavLM at
   the wavlm-base-plus widths (frozen, behind the 44.1 -> 16 kHz
   resampler) and WavLMDiscriminator(768, 13, 64) beside the same
   models, fused attention; the step with the SLM and the step without it
   in turns on the same batch: ms per step and peak memory of each, the
   K1-train/B5/B6/K3 launches of every step (22/22/22/1 with and without
   the SLM), finite loss/wd/total, loss/g/lm and loss/g/lm_gen, the WavLM
   discriminator moved and the WavLM did not; the SLM forward's time at
   [16, 16384] samples; the SLM terms (hidden states, the three losses,
   the discriminator's and the fake wave's gradients) card against CPU
   from the same weights at batch 2.
8. the training forward at a cut depth, dropout off, the same noise, on the
   card and on the CPU: equal alignments, losses and waves within bounds.
9. the training entry point: the Trainer (the CLI's) on a synthetic 44.1
   kHz corpus and a config.json with the V2.3 model section, fused
   attention, no SLM: K1-train/B5/B6 and MAS launches per step, finite
   metrics, moved parameters, a checkpoint; step time, peak memory, a
   profile of one step; then the CLI resumes on the same directory.
9b. the Trainer with the SLM losses ([trainer-slm]): a random WavLM at the
   published widths written as an HF checkpoint directory (config.json in
   HF keys, pytorch_model.bin), the corpus config's model.slm.model
   pointing at it, Trainer(slm_path="auto") loading it: 3 steps with the
   kernels' launches per step, finite SLM metrics, WD_3.pth beside
   G_/D_/DUR_3.pth, and a second Trainer that resumes (the WavLM
   discriminator as saved) and runs a fourth step.
9c. the Trainer from a config.json with "bf16_run": true ([trainer-bf16]):
   TRAINER_BF16_STEPS steps with fused attention, the kernels' launches
   per step (K1-train/B5/B6 6 fp32 + 16 bf16 each, K3 1), finite metrics,
   float32 checkpoints, and the CLI resuming for one more step.
9d. from a raw corpus to a served release ([prep]): PREP_UTTS JP and EN
   recordings (half 22.05 kHz stereo PCM16, half 48 kHz mono float32) and
   an esd.list through the wizard's steps (preprocess/wizard.py: config at
   batch 16, resample, text, bert with seeded noise, spec; in this
   process, each step timed), the rows, 44.1 kHz mono PCM16 outputs and the spec and BERT
   caches' shapes checked; the Trainer on the wizard's config.json (the
   V2.3 model section, bf16_run as the wizard writes it, fused attention,
   no SLM) with the native batch loader active: PREP_STEPS steps, each
   launching K1-train, B5 and B6 22 times (6 fp32 + 16 bf16) and K3 once,
   finite metrics, moved parameters, a checkpoint; load_collated_batch at
   the Trainer's batch with the native loader and with numpy in turns
   (medians beside the step's, the two batches equal); save_release of G
   in fp32 and fp16, each loaded by load_tts_engine on the card (every
   parameter but enc_q the checkpoint's, or its fp16 rounding) and asked
   for one JP sentence (K1 28, K2 3 launches), the fp32 release at zero
   noise card against CPU within WAVE_BOUND and equal to the checkpoint's
   engine; mix_params of the step-0 and the last generator served once.

9e. the data axis ([dist]): (a) K1's train mode, B5 and B6, fp32 and bf16,
   tensor-core and wide, on each half of a batch with the affine dropout
   salt against the full batch: out, dq, dk, dv bit-equal, the tables'
   gradients within SALT_TABLE_REL (fp32) or 8 bf16 ulps; (b) the Trainer
   as the one rank of an NCCL group against the Trainer outside any group,
   DIST_STEPS steps on one corpus, each in a child process of this script
   (side by side) with deterministic algorithms: bit-equal parameters; (c) two processes of
   this script sharing cuda:0 over gloo (torchrun's variables set), each a
   rank of DIST_STEPS data-parallel steps of the V2.3 models at
   TRAIN_BATCH / 2 rows, module dropouts off and the hash dropout on:
   K1-train/B5/B6 22 and K3 1 per rank per step, metrics and parameters
   equal across the ranks, the first step within DIST_REL_BOUND of the
   one-process step on the TRAIN_BATCH rows, ms per step, peak memory per
   rank and the step's gradient all-reduces alone; (d) TTSEngine on
   make_mesh(2, [cuda:0, cuda:0]) against the single engine at noise
   0.667 within DP_ENGINE_BOUND, K1 28 and K2 3 per replica, medians in
   turns; (e) NCCL across two cards only where the machine shows two
   (the phase says why it did not run).

The last three lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

FP32_FLOPS = 67e12  # H100 SXM fp32 rate outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
HBM_BYTES = 3.35e12  # H100 SXM HBM3 rate
K1_BOUND = 1e-4  # fp32, outputs O(1), sums of up to t terms in another order
K2_BOUND = 2e-4  # fp32, 18 chained convs of up to 11*C-term sums
WAVE_BOUND = 1e-3  # card vs CPU, fp32: 22 attention layers, spline, vocoder
MAIN_BATCH = 8
TIMED_CALLS = 5
FRAMES = 768  # frame cap the kernel checks use (128-token bucket x 6)
TRAIN_BATCH, TRAIN_TX, TRAIN_TY = 16, 128, 512
WARMUP_STEPS, TIMED_STEPS = 2, 5
LENGTH_REL_BOUND = 1e-3  # card vs CPU, fp32: the duration loss, relative
ATTN_RANGE_BOUND = 1e-5  # card vs CPU, fp32, TF32 off: one attention (wide kernel vs plain)
# K1 train mode, B5, B6 against the plain autograd, each error relative to
# the max of its reference: fp32 sums of up to t terms (rows) and of up to
# b*h*t terms (dek, dev: per-block partials added in block order) in
# another order than cuBLAS's and autograd's
BWD_REL_BOUND = 1e-4
N_ENC_ATTN, N_FLOW_ATTN = 6, 16  # attention layers of enc_p and of the flow
# bf16 kernels against their plain versions (which round where the TPU
# kernels round): bf16 ulps of the largest reference entry. K1: the kernel
# rounds P relative to the running max, the plain version the normalized P
# (each a relative 2**-9), and an fp32 sum in another order can flip the
# output's last rounding: 1 ulp and a little more. K2: a flipped rounding in
# one of 18 chained convs travels through the later convs and residuals.
K1_BF16_ULPS = 4
K2_BF16_ULPS = 4
BF16_ROUNDS = 3  # [bf16]: fp32 and bf16 run_prepared in turns, F B B F a round
# the [attention-range] phase: MultiHeadAttention (channels, heads, window)
# outside the tensor-core kernels' range, at [b, t] with these lengths; its
# kernels (csrc/banded_attn_wide.cu) checked at the same [b, h, t, d, w],
# each launched once per module call
RANGE_MODULES = ((160, 1, 4), (192, 2, 5))
RANGE_T, RANGE_LENS = 200, [200, 151, 77, 9]
WIDE_KEYS = ("banded_attn_wide_fwd_train", "banded_attn_wide_bwd_q",
             "banded_attn_wide_bwd_k")
TC_KEYS = ("banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k")
AB_ROUNDS = 3  # fused vs dense: D F F D per round
TRAINER_UTTS, TRAINER_WARMUP, TRAINER_TIMED = 32, 2, 6
SLM_ROUNDS = 2  # SLM vs no-SLM steps in turns: S N N S per round, after one warm-up each
SLM_CHECK_BATCH = 2  # the card-vs-CPU check of the SLM pieces
# card vs CPU, fp32, TF32 off: the WavLM's hidden states (post-LN, O(1); 12
# layers of 768- and 3072-term sums and 7 convs of up to 1536-term sums in
# another order), absolute; the SLM losses and the gradients (of the WavLM
# discriminator's parameters and of the fake wave), relative to the value
# and to each gradient's norm
WAVLM_BOUND = 1e-3
SLM_REL_BOUND = 1e-3
TRAINER_SLM_WARMUP, TRAINER_SLM_TIMED = 1, 2
# [train-bf16]: K1's train mode, B5 and B6 on bf16 operands against their
# plain bf16 versions (which round where the TPU kernels round), in bf16
# ulps of the largest reference entry: a reordered fp32 sum can flip the
# rounding of ds or p*ks to bf16 (each 2**-9 of an entry) before the
# products, and of each output at the end; dek and dev round once after
# their fp32 sums. m and l stay within BWD_REL_BOUND.
BWD_BF16_ULPS = 4
TC_BF16_KEYS = ("banded_attn_fwd_train_bf16", "banded_attn_bwd_q_bf16",
                "banded_attn_bwd_k_bf16")
WIDE_BF16_KEYS = ("banded_attn_wide_fwd_train_bf16", "banded_attn_wide_bwd_q_bf16",
                  "banded_attn_wide_bwd_k_bf16")
# the first bf16 step's losses against the fp32 step's from the same
# weights, batch and noise, |a - b| / (|b| + 1e-3): the JAX package's own
# bounds (tests/test_train.py TestBf16TrainStep)
BF16_LOSS_REL = {"loss/g/mel": 0.15, "loss/d/total": 0.15, "loss/g/kl": 0.35}
TRAIN_BF16_ROUNDS = 2  # fp32 and bf16 steps in turns, F B B F a round
# card vs CPU in bf16 (cuDNN's and the CPU's bf16 convs, the kernels and the
# plain versions round at different points through 16 WN layers, the flow
# and the vocoder slice): each output within this share of its largest
# entry (~5 bf16 ulps); parameter gradients of a bf16 attention module
# within it of the largest gradient entry
BF16_CPU_REL = 2e-2
TRAINER_BF16_STEPS = 3


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_mem = flops / FP32_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def bound_bf16(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of work on bf16 operands: the bf16 tensor-core rate
    or the bytes."""
    t_ops, t_mem = flops / BF16_FLOPS, nbytes / HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def bound_fp32(flops: float, nbytes: float) -> float:
    """The bound of a design on the fp32 cores (the wide kernels): the
    fp32 rate or the bytes."""
    return bound(flops, nbytes)[0]


def bound_3xtf32(flops: float, nbytes: float) -> float:
    """The bound of the kernels' design (K1, K2, B5, B6): every fp32
    product as three TF32 tensor-core products (3xTF32) at the TF32 rate,
    or the bytes."""
    return max(3 * flops / TF32_FLOPS, nbytes / HBM_BYTES) * 1e3


def device_ms(fn, iters: int = 10) -> float:
    """Device time of fn per call: the kernels' own time in a profiler
    trace of `iters` calls after a warm-up, summed over every kernel the
    call launches (no host time between them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters


def lens_mask(lens, t, dev):
    return (torch.arange(t, device=dev)[None, :]
            < torch.as_tensor(lens, device=dev)[:, None]).float()


def range_cases():
    """The wide kernels' shapes: (name, b, h, t, d, w, launches per call)."""
    return [(f"d{c // h}w{w}", len(RANGE_LENS), h, RANGE_T, c // h, w, 1)
            for c, h, w in RANGE_MODULES]


def check_attention(dev, cases=None, label="K1", design=bound_3xtf32,
                    dtype=torch.float32):
    """The inference launch against the plain version, timed: K1 at the
    serving path's shapes, or (cases) the wide kernel at its own; with
    dtype bfloat16 the bf16 mode on bf16 operands (mask float32), bounded
    by K1_BF16_ULPS bf16 ulps of the largest reference entry, and the
    least time at the bf16 rate and 2-byte operands."""
    from bert_vits2_tpu_torch.ops.attention import (
        banded_attention_plain, banded_rel_self_attention)
    rows = []
    # enc_p at the 128-token bucket; the flow at a 768-frame cap
    for name, b, h, t, d, w, n_main in cases or (
            ("enc_p", MAIN_BATCH, 2, 128, 96, 4, 12),
            ("flow", MAIN_BATCH, 2, FRAMES, 96, 4, 16)):
        g = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g)
                   for _ in range(3))
        q = q / math.sqrt(d)
        ek, ev = (torch.randn(2 * w + 1, d, device=dev, generator=g)
                  / math.sqrt(d) for _ in range(2))
        q, k, v, ek, ev = (a.to(dtype) for a in (q, k, v, ek, ev))
        m = lens_mask([t - (t // 16) * i for i in range(b)], t, dev)
        args = (q, k, v, m, ek, ev, w)
        with torch.inference_mode():
            got = banded_rel_self_attention(*args)
            want = banded_attention_plain(*args)
            torch.cuda.synchronize()
            valid = m.bool()[:, None, :, None].expand_as(got)
            err = (got.float() - want.float()).abs()[valid].max().item()
            ms = cuda_ms(lambda: banded_rel_self_attention(*args))
            dms = device_ms(lambda: banded_rel_self_attention(*args))
            plain = cuda_ms(lambda: banded_attention_plain(*args))
        flops = 4 * b * h * t * t * d + 4 * b * h * t * (2 * w + 1) * d
        size = q.element_size()
        nbytes = size * (4 * b * h * t * d + 2 * (2 * w + 1) * d) + 4 * b * t
        if dtype == torch.float32:
            bms, by = bound(flops, nbytes)
            tol, unit = K1_BOUND, "67 TFLOP/s fp32"
        else:
            bms, by = bound_bf16(flops, nbytes)
            scale = want.float().abs()[valid].max().item()
            tol, unit = K1_BF16_ULPS * bf16_ulp(scale), "989 TFLOP/s bf16"
        tc = design(flops, nbytes)
        log(f"{label} {name} [b={b},h={h},t={t},d={d},w={w}] {str(dtype)[6:]}: "
            f"max_abs_err {err:.3e} (bound {tol:g}), kernel {ms:.4f} ms (device "
            f"{dms:.4f} ms), plain {plain:.4f} ms, bound {bms:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP at {unit}, {nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s), design bound {tc:.4f} ms")
        if not err <= tol:
            raise AssertionError(f"{label} {name}: max_abs_err {err} > {tol}")
        rows.append(dict(shape=[b, h, t, d], launches_per_call=n_main, err=err,
                         ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                         bound_by=by, bound_design_ms=tc))
    return rows


def check_attention_bwd(dev, cases=None, keys=TC_KEYS, design=bound_3xtf32,
                        dtype=torch.float32):
    """K1 in train mode, B5 and B6 (or, with cases and keys, the wide
    kernels) against the plain version's autograd on the card: out, the
    row statistics and the five gradients on valid rows, without and with
    the hash dropout (one seed). With dtype bfloat16 their bf16 modes on
    bf16 operands against the plain bf16 versions (the backward's given the
    kernels' m, l and delta): out and the gradients within BWD_BF16_ULPS
    bf16 ulps of the largest reference entry, m and l within BWD_REL_BOUND;
    the least time at 989 TFLOP/s and 2-byte operands."""
    from bert_vits2_tpu_torch.ops.attention import (
        banded_attention_bwd_plain, banded_attention_bwd_plain_bf16,
        banded_attention_bwd_q, banded_attention_bwd_k, banded_attention_fwd_train,
        banded_attention_plain, banded_attention_stats_plain)
    bf16 = dtype == torch.bfloat16
    rows = {key: [] for key in keys}
    seed = -1234567
    # the flow and enc_p of the training batch, launches per step; one
    # ragged odd length over several key tiles
    for name, b, h, t, d, w, n_main in cases or (
            ("flow", TRAIN_BATCH, 2, TRAIN_TY, 96, 4, N_FLOW_ATTN),
            *(() if bf16 else (("enc_p", TRAIN_BATCH, 2, TRAIN_TX, 96, 4, N_ENC_ATTN),)),
            ("ragged", 2, 2, 1001, 96, 4, 0)):
        g = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g)
                   for _ in range(3))
        q = q / math.sqrt(d)
        ek, ev = (torch.randn(2 * w + 1, d, device=dev, generator=g)
                  / math.sqrt(d) for _ in range(2))
        m = lens_mask([t - (t // 16) * i for i in range(b)], t, dev)
        go = torch.randn(b, h, t, d, device=dev, generator=g) * m[:, None, :, None]
        q, k, v, ek, ev, go = (a.to(dtype) for a in (q, k, v, ek, ev, go))
        valid = m.bool()[:, None, :]
        for p_drop in (0.0, 0.1):
            args = (q, k, v, m, ek, ev, w, p_drop, seed)
            fwd = lambda: banded_attention_fwd_train(*args)  # noqa: E731
            out, mr, lr = fwd()
            delta = (go.float() * out.float()).sum(-1)
            bargs = (q, k, v, m, ek, ev, go, mr, lr, delta, w, p_drop, seed)
            dq, dek, dvv = banded_attention_bwd_q(*bargs)
            dk, dv = banded_attention_bwd_k(*bargs)
            want_out = banded_attention_plain(*args[:7], p_drop, seed)
            want_m, want_l = banded_attention_stats_plain(q, k, m, ek, w)
            plain_bwd = (lambda: banded_attention_bwd_plain_bf16(*bargs)) if bf16 else (
                lambda: banded_attention_bwd_plain(q, k, v, m, ek, ev, go, w, p_drop, seed))
            want = plain_bwd()
            torch.cuda.synchronize()
            if not all(x.dtype == dtype for x in (out, dq, dk, dv, dek, dvv)):
                raise AssertionError(f"{'/'.join(keys)}: an output is not {dtype}")

            errs, abs_errs, ulps = {}, {}, {}
            for key, got, ref in zip(
                    ("out", "m", "l", "dq", "dk", "dv", "dek", "dev"),
                    (out, mr, lr, dq, dk, dv, dek, dvv), (want_out, want_m, want_l, *want)):
                got, ref = got.float(), ref.float()
                if got.dim() > 2:  # valid rows only
                    got, ref = got[valid.expand(b, h, t)], ref[valid.expand(b, h, t)]
                abs_errs[key] = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if bf16 and key not in ("m", "l"):
                    ulps[key] = abs_errs[key] / bf16_ulp(scale)
                elif key != "out":
                    errs[key] = abs_errs[key] / scale
            out_ok = bf16 or abs_errs["out"] <= K1_BOUND
            log(f"{'/'.join(keys)} {name} [b={b},h={h},t={t},d={d},w={w}]"
                f"{' bf16' if bf16 else ''} p_drop {p_drop}: "
                + (f"bf16 ulps of the largest entry: " + ", ".join(
                    f"{k_} {u:.2f}" for k_, u in ulps.items())
                   + f" (bound {BWD_BF16_ULPS}); " if bf16 else
                   f"out max_abs_err {abs_errs['out']:.3e} (bound {K1_BOUND:g}); ")
                + "relative to the max: " + ", ".join(
                    f"{k_} {e:.2e}" for k_, e in errs.items())
                + f" (bound {BWD_REL_BOUND:g})")
            if not (out_ok and all(u <= BWD_BF16_ULPS for u in ulps.values())
                    and all(e <= BWD_REL_BOUND for e in errs.values())):
                raise AssertionError(f"{'/'.join(keys)} {name} {dtype} p_drop {p_drop} "
                                     f"disagree with the plain versions")
            if p_drop == 0.0 or n_main == 0:
                continue
            # timing at the training rate p_drop = 0.1
            ms_f = cuda_ms(fwd)
            ms_q = cuda_ms(lambda: banded_attention_bwd_q(*bargs))
            ms_k = cuda_ms(lambda: banded_attention_bwd_k(*bargs))
            dev_f = device_ms(fwd)
            dev_q = device_ms(lambda: banded_attention_bwd_q(*bargs))
            dev_k = device_ms(lambda: banded_attention_bwd_k(*bargs))
            plain_f = cuda_ms(lambda: (banded_attention_plain(*args[:7], p_drop, seed),
                                       banded_attention_stats_plain(q, k, m, ek, w)))
            if bf16:
                plain_b = cuda_ms(plain_bwd, iters=5)
            else:
                leaves = [a.detach().requires_grad_() for a in (q, k, v, ek, ev)]
                with torch.enable_grad():
                    o = banded_attention_plain(leaves[0], leaves[1], leaves[2], m,
                                               leaves[3], leaves[4], w, p_drop, seed)
                    plain_b = cuda_ms(lambda: torch.autograd.grad(
                        o, leaves, go, retain_graph=True), iters=5)
                del o, leaves
            nb = 2 * w + 1
            size = q.element_size()  # operands' bytes; m, l, delta fp32
            io = size * (b * t + 2 * nb * d)  # mask and the tables
            fwd_flops = 4 * b * h * t * t * d + 4 * b * h * t * nb * d
            fwd_bytes = io + size * 4 * b * h * t * d + 4 * 2 * b * h * t
            # B5: s, g.v, ds.k; B6: s, g.v, p.g, ds.q (+ the band terms)
            q_work = (6 * b * h * t * t * d + 6 * b * h * t * nb * d,
                      io + size * (5 * b * h * t * d + 2 * nb * d) + 4 * 3 * b * h * t)
            k_work = (8 * b * h * t * t * d + 4 * b * h * (t + 2 * w) * nb * d,
                      io + size * 6 * b * h * t * d + 4 * 3 * b * h * t)
            # the tensor-core kernels run their fp32 products as 3xTF32,
            # their bf16 ones at the bf16 rate, the wide ones on the fp32
            # cores (design)
            for key, ms, dms, plain, work, outs in (
                    (keys[0], ms_f, dev_f, plain_f, (fwd_flops, fwd_bytes),
                     ("out", "m", "l")),
                    (keys[1], ms_q, dev_q, plain_b, q_work, ("dq", "dek", "dev")),
                    (keys[2], ms_k, dev_k, plain_b, k_work, ("dk", "dv"))):
                bms, by = (bound_bf16 if bf16 else bound)(*work)
                tc = design(*work)
                log(f"{key} {name} [b={b},h={h},t={t},d={d},w={w}] p_drop {p_drop}: "
                    f"kernel {ms:.4f} ms (device {dms:.4f} ms), plain "
                    f"{plain:.4f} ms, bound {bms:.4f} ms ({by}: {work[0] / 1e9:.2f} "
                    f"GFLOP, {work[1] / 1e6:.1f} MB), design bound {tc:.4f} ms")
                rows[key].append(dict(
                    shape=[b, h, t, d], launches_per_call=n_main,
                    err=max(abs_errs[o] for o in outs), ms=ms, device_ms=dms,
                    plain_ms=plain, bound_ms=bms, bound_by=by, bound_design_ms=tc))
            del bargs
        torch.cuda.empty_cache()
    log(f"[kernels] plain time of B5 and of B6: the plain version's "
        f"{'explicit bf16 backward' if bf16 else 'autograd backward'}, which "
        "computes both kernels' outputs in one pass")
    return rows


def check_mrf(dev, dtype=torch.float32):
    """K2 against its plain version at the serving path's three stages,
    timed; with dtype bfloat16 its bf16 mode (weights packed in bf16, x and
    the mask bf16), bounded by K2_BF16_ULPS bf16 ulps of the largest
    reference entry, the least time at the bf16 rate."""
    from bert_vits2_tpu_torch.models.generator import ResBlock1
    from bert_vits2_tpu_torch.ops.mrf import (
        fused_mrf, fused_mrf_plain, prepare_mrf_weights)
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    rows = []
    torch.manual_seed(0)
    for c, up in ((64, 128), (32, 256), (16, 512)):
        t = up * FRAMES
        blocks = [ResBlock1(c, k, d) for k, d in zip(ks, ds)]
        with torch.no_grad():
            for blk in blocks:  # unit-gain convs, not the near-identity init
                for conv in (*blk.convs1, *blk.convs2):
                    conv.weight_g.fill_(1.0)
                    conv.bias.normal_(0.0, 0.1)
        wts = prepare_mrf_weights([blk.to(dev) for blk in blocks], dtype)
        g = torch.Generator(device=dev).manual_seed(c)
        x = torch.randn(MAIN_BATCH, c, t, device=dev, generator=g).to(dtype)
        m = lens_mask([t - up * 37 * i for i in range(MAIN_BATCH)], t, dev).to(dtype)
        with torch.inference_mode():
            got = fused_mrf(x, m, wts)
            want = fused_mrf_plain(x, m, wts)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            masked = got[m[:, None, :].expand_as(got) == 0].abs().max().item()
            del got, want
            ms = cuda_ms(lambda: fused_mrf(x, m, wts), iters=5)
            dms = device_ms(lambda: fused_mrf(x, m, wts), iters=3)
            plain = cuda_ms(lambda: fused_mrf_plain(x, m, wts), iters=3, warmup=1)
        macs = sum(2 * c * c * k * len(dd) for k, dd in zip(ks, ds))
        flops = 2 * macs * MAIN_BATCH * t
        size = x.element_size()
        nbytes = size * (2 * MAIN_BATCH * c * t + MAIN_BATCH * t) + 4 * wts.flat.numel()
        if dtype == torch.float32:
            bms, by = bound(flops, nbytes)
            tc = bound_3xtf32(flops, nbytes)
            tol = K2_BOUND
            units = ("67 TFLOP/s fp32", "3xTF32 bound", "3 x FLOP at 495 TFLOP/s")
        else:
            bms, by = bound_bf16(flops, nbytes)
            tc = bms
            tol = K2_BF16_ULPS * bf16_ulp(scale)
            units = ("989 TFLOP/s bf16", "design bound", "one bf16 MMA a product")
        log(f"K2 C={c} [B={MAIN_BATCH},T={t}] {str(dtype)[6:]}: max_abs_err "
            f"{err:.3e} (bound {tol:g}), masked outputs max |y| {masked:.1e} (must "
            f"be 0), kernel {ms:.3f} ms (device {dms:.3f} ms), plain "
            f"{plain:.3f} ms, bound {bms:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP "
            f"at {units[0]}, {nbytes / 1e6:.1f} MB at 3.35 TB/s), {units[1]} "
            f"{tc:.3f} ms ({units[2]})")
        if not (err <= tol and masked == 0.0):
            raise AssertionError(f"K2 C={c} {dtype}: max_abs_err {err} > {tol} "
                                 f"or masked outputs {masked} != 0")
        rows.append(dict(shape=[MAIN_BATCH, c, t], launches_per_call=1, err=err,
                         ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                         bound_by=by, bound_design_ms=tc))
    return rows


def ragged_lengths(rng, b, t_y, t_x):
    """Per-item (t_y, t_x) with t_x <= t_y, the first item at full length."""
    t_ys = rng.integers(t_y // 2, t_y + 1, b)
    t_xs = np.minimum(rng.integers(max(t_x // 2, 1), t_x + 1, b), t_ys)
    t_ys[0], t_xs[0] = t_y, min(t_x, t_y)
    return t_ys, t_xs


LINKS = ("fmax+add", "shuffle+fmax+add", "shared load", "walk step", "barrier")


def link_ns(dev) -> dict[str, float]:
    """ns per link of each dependent chain `mas_link_probe` runs: kinds 0-3
    in one warp, the barrier in a block of TRAIN_TX threads."""
    from bert_vits2_tpu_torch import _build
    out = torch.zeros(1024, device=dev)
    steps, ns = 200_000, {}
    for kind, name in enumerate(LINKS):
        threads = TRAIN_TX if name == "barrier" else 32
        probe = lambda: _build.check(_build.library("mas.cu").mas_link_probe(  # noqa: E731
            out.data_ptr(), steps, kind, threads, 0,
            torch.cuda.current_stream().cuda_stream), "mas_link_probe")
        ns[name] = cuda_ms(probe, iters=3, warmup=1) * 1e6 / steps
    return ns


def check_mas(dev):
    from bert_vits2_tpu_torch.ops.align import mas_plan, maximum_path, maximum_path_plain
    rng = np.random.default_rng(3)
    links = link_ns(dev)
    log("[kernels] K3 links, ns each: " + ", ".join(f"{k} {v:.2f}" for k, v in links.items()))
    rows = []
    # the training step's shape (timed, the main path's); the Trainer's
    # longest text (2 * 384 + 1 tokens); a long text with the decisions in
    # device memory; b = 1; t_x == t_y (the path is the diagonal)
    for b, t_y, t_x, n_main in ((TRAIN_BATCH, TRAIN_TY, TRAIN_TX, 1), (8, 1500, 769, 0),
                                (2, 1500, 1100, 0), (1, 300, 50, 0), (3, 96, 96, 0)):
        g = torch.Generator(device=dev).manual_seed(t_y)
        neg = torch.randn(b, t_y, t_x, device=dev, generator=g) * 30.0 - 300.0
        t_ys, t_xs = ragged_lengths(rng, b, t_y, t_x)
        lens = [torch.as_tensor(a, device=dev) for a in (t_ys, t_xs)]
        before = maximum_path.launches
        got = maximum_path(neg, *lens)
        want = maximum_path_plain(neg, *lens)
        torch.cuda.synchronize()
        differ = int((got != want).sum().item())
        plan = mas_plan(t_y, t_x)
        log(f"K3 [b={b},t_y={t_y},t_x={t_x}] ragged, plan k={plan.k} warps={plan.warps} "
            f"decisions in {'shared' if plan.dec_in_smem else 'device'} memory: cells "
            f"that differ from the plain version {differ} (must be 0); path cells "
            f"{int(got.sum().item())} = frames {int(t_ys.sum())}; launches "
            f"{maximum_path.launches - before}")
        if (differ or int(got.sum().item()) != int(t_ys.sum())
                or maximum_path.launches != before + 1):
            raise AssertionError(f"K3 [b={b},t_y={t_y},t_x={t_x}] is not exact")
        if t_y < 512:
            continue
        ms = cuda_ms(lambda: maximum_path(neg, *lens), iters=20)
        dms = device_ms(lambda: maximum_path(neg, *lens), iters=20)
        plain = cuda_ms(lambda: maximum_path_plain(neg, *lens), iters=2, warmup=1)
        # bytes: the scores of the valid cells read once, the path written
        # once (the move-left bits are scratch); operations: a max and an
        # add per valid cell
        cells = int((t_ys * t_xs).sum())
        nbytes = 4 * (cells + b * t_y * t_x)
        bms, by = bound(2 * cells, nbytes)
        frames = int(t_ys.max())
        # two dependent chains of `frames` links: the frames, then the walk
        chain_reg = 2 * frames * links["fmax+add"] / 1e6
        chain_design = frames * (links["shuffle+fmax+add"] + links["walk step"]) / 1e6
        log(f"K3 [b={b},t_y={t_y},t_x={t_x}]: kernel {ms:.4f} ms (device {dms:.4f} ms), "
            f"plain {plain:.2f} ms, bound {bms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB at "
            f"3.35 TB/s); the chains of {frames} frames and {frames} walk steps: at "
            f"the register link {chain_reg:.4f} ms, at the design's links (a shuffle "
            f"link per frame, a walk-step link per row) {chain_design:.4f} ms; device "
            f"time / register-link chain {dms / max(bms, chain_reg):.1f}x")
        rows.append(dict(shape=[b, t_y, t_x], launches_per_call=n_main, err=0.0, ms=ms,
                         device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         bound_design_ms=max(bms, chain_reg),
                         chain_design_ms=chain_design, plan=list(plan[:3])))
    rows[0]["link_ns"] = links
    return rows


def check_attention_range(dev, counters):
    """Attention outside the tensor-core kernels' range (a head of 160
    channels; a window of 5), the path of csrc/banded_attn_wide.cu: each
    wide kernel against its plain version and timed at the module's
    shapes; then MultiHeadAttention on the card and on the CPU at
    inference and in fused training (BV2_FUSED_ATTENTION_TRAIN=1, the hash
    dropout from one seed), every launch count zeroed just before: outputs
    within ATTN_RANGE_BOUND on valid positions, parameter gradients within
    BWD_REL_BOUND of the largest gradient entry, each wide kernel launched and no
    tensor-core one. Returns (rows by kernel, launches)."""
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    rows = {"banded_attn_wide_fwd": check_attention(dev, range_cases(), "K1-wide",
                                                    bound_fp32)}
    rows.update(check_attention_bwd(dev, range_cases(), WIDE_KEYS, bound_fp32))
    t, lens = RANGE_T, RANGE_LENS
    modules = []
    for channels, heads, window in RANGE_MODULES:
        torch.manual_seed(channels)
        cpu = MultiHeadAttention(channels, channels, heads, window_size=window,
                                 p_dropout=0.1)
        gpu = MultiHeadAttention(channels, channels, heads, window_size=window,
                                 p_dropout=0.1).to(dev)
        gpu.load_state_dict(cpu.state_dict())
        modules.append((channels, heads, window, cpu, gpu, torch.randn(len(lens), channels, t),
                        torch.randn(len(lens), channels, t)))
    m = lens_mask(lens, t, "cpu")[:, None, :]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    errs = {}
    try:
        for channels, heads, window, cpu, gpu, x, r in modules:
            for train in (False, True):
                outs, grads = [], []
                for mod, where in ((cpu, "cpu"), (gpu, dev)):
                    mod.train(train)
                    mod.zero_grad()
                    torch.manual_seed(7)  # the hash dropout's seed
                    with torch.set_grad_enabled(train):
                        out = mod(x.to(where), m.to(where)) * m.to(where)
                        if train:
                            (out * r.to(where)).sum().backward()
                    outs.append(out.detach().cpu())
                    grads.append([p.grad.cpu() for p in mod.parameters()] if train
                                 else [])
                torch.cuda.synchronize()
                key = (channels, heads, window, "training" if train else "inference")
                # gradients against the largest entry of any: conv_k's bias
                # has a zero gradient in exact arithmetic
                scale = max((g.abs().max().item() for g in grads[0]), default=1.0)
                errs[key] = ((outs[0] - outs[1]).abs().max().item(), max(
                    (g1 - g0).abs().max().item() / scale
                    for g0, g1 in zip(*grads)) if train else 0.0)
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    launches = {k: fn.launches for k, fn in counters.items()}
    for (channels, heads, window, mode), (e_out, e_grad) in errs.items():
        log(f"[attention-range] channels {channels}, {heads} head(s) (d = "
            f"{channels // heads}), window {window}, [b={len(lens)}, t={t}], {mode}: "
            f"card vs CPU output max_abs_err {e_out:.2e} (bound {ATTN_RANGE_BOUND:g}), "
            f"parameter gradients {e_grad:.2e} of the largest entry (bound "
            f"{BWD_REL_BOUND:g})")
    log(f"[attention-range] kernel launches {launches}")
    n = len(RANGE_MODULES)
    want = {k: 0 for k in counters}
    want.update({k: n for k in ("banded_attn_wide_fwd", *WIDE_KEYS)})
    if launches != want:
        raise AssertionError(f"[attention-range] kernel launches {launches}, not {want}")
    if not all(e_out <= ATTN_RANGE_BOUND and e_grad <= BWD_REL_BOUND
               for e_out, e_grad in errs.values()):
        raise AssertionError(f"attention outside the tensor-core range: {errs}")
    return rows, {k: launches[k] for k in ("banded_attn_wide_fwd", *WIDE_KEYS)}


def nonzero_init(model, seed=1):
    """The reference initializes the flow's `post` and the SDP spline `proj`
    convs to zero (identity couplings): give them small random weights so
    that the flows do work."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".post." in name or (name.startswith("sdp.") and ".proj." in name
                                    and "flows." in name):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)


def make_model(device, state_dict=None):
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models import build_synthesizer
    model = build_synthesizer(ModelConfig(), device=device, seed=0,
                              state_dict=state_dict)
    if state_dict is None:
        # bias the duration predictor to ~4.5 frames per token so the frame
        # counts look like speech
        nonzero_init(model)
        with torch.no_grad():
            model.dp.proj.bias.fill_(1.5)
    return model


def make_requests(cfg, n, seed):
    from bert_vits2_tpu_torch.infer import PreparedRequest
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        t = int(rng.integers(32, 129))
        feats = [(0.5 * rng.normal(size=(t, cfg.bert_dim))).astype(np.float32)
                 for _ in range(3)]
        reqs.append(PreparedRequest(
            inputs=(rng.integers(1, cfg.n_vocab, t), rng.integers(0, cfg.num_tones, t),
                    rng.integers(0, cfg.num_languages, t), *feats),
            sid=int(rng.integers(0, cfg.n_speakers)), seed=seed))
    return reqs


def make_train_batch(cfg, hop, b, t_x, t_y, seed, dev):
    """A synthetic training batch from a numpy seed, ragged lengths."""
    rng = np.random.default_rng(seed)
    spec_lengths, x_lengths = ragged_lengths(rng, b, t_y, t_x)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    host = dict(
        x=rng.integers(1, cfg.n_vocab, (b, t_x)), x_lengths=x_lengths,
        spec=f32(rng.normal(size=(b, t_y, cfg.spec_channels)) * 0.1),
        spec_lengths=spec_lengths,
        wave=f32(rng.uniform(-0.5, 0.5, (b, t_y * hop))),
        sid=rng.integers(0, cfg.n_speakers, (b,)),
        tone=rng.integers(0, cfg.num_tones, (b, t_x)),
        language=rng.integers(0, cfg.num_languages, (b, t_x)),
        bert=f32(rng.normal(size=(b, t_x, cfg.bert_dim))),
        ja_bert=f32(rng.normal(size=(b, t_x, cfg.bert_dim))),
        en_bert=f32(rng.normal(size=(b, t_x, cfg.bert_dim))),
    )
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def profile_lines(prof, wall, what, top=12):
    from torch.autograd import DeviceType
    # kernels and copies only: the optimizers' "Optimizer.step#..." ranges
    # also arrive as device events and span kernels already counted
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Optimizer.")]
    dev_us = sum(e.self_device_time_total for e in evs)
    log(f"[profile] {what}: wall {wall * 1e3:.1f} ms, device busy "
        f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")
    return evs, dev_us


def run_training(dev, smi, counters):
    """Phase 7: a few GAN steps at the default V2.3 config, full width."""
    from torch.profiler import ProfilerActivity, profile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    from bert_vits2_tpu_torch.train import (
        DataConfig, TrainConfig, init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    cfg, data_cfg, train_cfg = ModelConfig(), DataConfig(), TrainConfig()
    t0 = time.perf_counter()
    models = init_params(build_models(cfg, device="cuda"), cfg, seed=1234)
    state = init_train_state(models, train_cfg)
    step = make_train_step(models, train_cfg, data_cfg, cfg.segment_size)
    n_params = [sum(p.numel() for p in m.parameters()) for m in models[:3]]
    batch = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX,
                             TRAIN_TY, seed=0, dev=dev)
    log(f"[train] default V2.3 config, fp32, TF32 off: parameters G/D/durD "
        f"{n_params}; batch {TRAIN_BATCH}, tokens {batch['x_lengths'].tolist()}, "
        f"frames {batch['spec_lengths'].tolist()}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    before = [[p.detach().clone() for p in m.parameters()] for m in models[:3]]
    seen = {}
    hook = models.synthesizer.register_forward_hook(
        lambda mod, args, out: seen.update(attn=out["attn"]))
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    lr = train_cfg.learning_rate

    def one_step():
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen, lr)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, metrics

    for _ in range(WARMUP_STEPS):
        one_step()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times, metrics = [], None
    for _ in range(TIMED_STEPS):
        sec, metrics = one_step()
        times.append(sec)
        bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f"non-finite metrics at step {state.step}: {bad}")
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for key in ("loss/d/total", "loss/dur_disc/total", "loss/g/total", "grad_norm_g"):
        if key not in metrics:
            raise AssertionError(f"metric {key} is missing")
    log("[train] step " + str(state.step) + ": " + ", ".join(
        f"{k} {float(v):.4g}" for k, v in sorted(metrics.items())))
    if launches["mas_fwd"] != TIMED_STEPS:
        raise AssertionError(f"kernel launches over {TIMED_STEPS} steps: {launches}")
    for name, module, old in zip(("G", "D", "duration D"), models[:3], before):
        moved = sum(not torch.equal(p.detach(), o)
                    for p, o in zip(module.parameters(), old))
        log(f"[train] {name}: {moved} of {len(old)} parameter tensors changed")
        if moved < 0.9 * len(old):
            raise AssertionError(f"{name} parameters did not move")
    del before

    attn = seen["attn"]
    y_len, x_len = batch["spec_lengths"], batch["x_lengths"]
    y_valid = torch.arange(TRAIN_TY, device=dev)[None, :] < y_len[:, None]
    token = attn.argmax(2)
    steps_ok = all(
        bool(((d := torch.diff(token[i, :int(n)])) >= 0).all() and (d <= 1).all())
        and int(token[i, 0]) == 0 and int(token[i, int(n) - 1]) == int(x_len[i]) - 1
        for i, n in enumerate(y_len.tolist()))
    if not (torch.equal(attn.sum(2), y_valid.float()) and steps_ok):
        raise AssertionError("attn is not a monotonic one-token-per-frame path")
    log(f"[train] attn {list(attn.shape)}: one token per valid frame, each "
        f"item from token 0 to its last token in steps of 0 or 1")

    med = float(np.median(times))
    log(f"[train-timing] {smi}: {TIMED_STEPS} steps after {WARMUP_STEPS} warm-up: "
        f"median {med * 1e3:.1f} ms, max {max(times) * 1e3:.1f} ms per step; "
        f"{1 / med:.3f} steps/s; peak memory {peak:.2f} GiB; kernel launches "
        f"{launches}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = one_step()
    evs, dev_us = profile_lines(prof, wall, "one training step", top=16)
    mas = [e for e in evs if "mas_kernel" in e.key]
    n_mas = sum(e.count for e in mas)
    mas_us = sum(e.self_device_time_total for e in mas)
    log(f"[profile] mas_kernel: {n_mas} launch in the step, {mas_us / 1e3:.4f} ms, "
        f"{100 * mas_us / max(dev_us, 1e-9):.3f}% of device time")
    if n_mas != 1:
        raise AssertionError(f"the profiler saw {n_mas} MAS kernel launches in a step")
    hook.remove()

    # the attention's training direction, fused (K1 train mode, B5, B6)
    # against dense, on this batch and these weights, in turns in one call
    n_attn = sum(isinstance(m, MultiHeadAttention)
                 for m in models.synthesizer.modules())
    fused_names = ("banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k")
    times, peaks = {"dense": [], "fused": []}, {"dense": 0.0, "fused": 0.0}
    order = ["fused"] + ["dense", "fused", "fused", "dense"] * AB_ROUNDS
    try:
        for i, mode in enumerate(order):  # the first fused step warms up
            os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1" if mode == "fused" else "0"
            before = [counters[k].launches for k in fused_names]
            torch.cuda.reset_peak_memory_stats()
            sec, metrics = one_step()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = [counters[k].launches - b for k, b in zip(fused_names, before)]
            want = [n_attn if mode == "fused" else 0] * 3
            if got != want:
                raise AssertionError(f"{mode} step launched {got}, not {want}")
            bad = {k: float(v) for k, v in metrics.items()
                   if not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f"non-finite metrics in a {mode} step: {bad}")
            if i:
                times[mode].append(sec)
                peaks[mode] = max(peaks[mode], peak)
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[train-ab] {smi}: the same batch and weights, {len(times['fused'])} "
        f"steps each in turns (D F F D): fused attention median "
        f"{med['fused'] * 1e3:.1f} ms (max {max(times['fused']) * 1e3:.1f}), peak "
        f"{peaks['fused']:.2f} GiB, {n_attn} launches each of K1-train/B5/B6 per "
        f"step; dense median {med['dense'] * 1e3:.1f} ms (max "
        f"{max(times['dense']) * 1e3:.1f}), peak {peaks['dense']:.2f} GiB; "
        f"fused/dense {med['fused'] / med['dense']:.3f}")
    del models, state, step
    torch.cuda.empty_cache()
    return launches


V23_MODEL_JSON = dict(  # the model section of the reference's V2.3 config.json
    use_spk_conditioned_encoder=True, use_noise_scaled_mas=True,
    use_mel_posterior_encoder=False, use_duration_discriminator=True,
    inter_channels=192, hidden_channels=192, filter_channels=768, n_heads=2,
    n_layers=6, kernel_size=3, p_dropout=0.1, resblock="1",
    resblock_kernel_sizes=[3, 7, 11],
    resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    upsample_rates=[8, 8, 2, 2, 2], upsample_initial_channel=512,
    upsample_kernel_sizes=[16, 16, 8, 2, 2], n_layers_q=3,
    use_spectral_norm=False, gin_channels=512,
    slm=dict(model="./slm/wavlm-base-plus", sr=16000, hidden=768, nlayers=13,
             initial_channel=64),
)


def write_corpus(root, n_utts, seed=0, slm_dir=None, bf16_run=False,
                 batch_size=TRAIN_BATCH):
    """A synthetic corpus for the Trainer: 44.1 kHz int16 wavs of 401-500
    frames (one bucket of the sampler), 40-63 phones each (128 text slots
    after the blanks), cached BERT features, a cleaned filelist in three
    languages and four speakers, and a config.json with the V2.3 model
    section (its model.slm.model set to `slm_dir` when given),
    train.bf16_run and train.batch_size. Returns the config path."""
    from scipy.io import wavfile

    from bert_vits2_tpu_torch.text.symbols import SYMBOLS

    rng = np.random.default_rng(seed)
    hop, sr = 512, 44100
    rows = []
    for i in range(n_utts):
        path = os.path.join(root, f"utt{i}.wav")
        n_frames = int(rng.integers(402, 500))
        audio = 0.3 * np.sin(np.arange(n_frames * hop) * 2 * np.pi
                             * rng.uniform(100, 400) / sr)
        audio += 0.05 * rng.normal(size=audio.shape)
        wavfile.write(path, sr, (audio * 32767).astype(np.int16))
        n_ph = int(rng.integers(40, 64))
        phones = rng.choice(SYMBOLS[1:], n_ph)
        np.save(path.replace(".wav", ".bert.npy"),
                (0.5 * rng.normal(size=(2 * n_ph + 1, 1024))).astype(np.float32))
        tones = " ".join(str(int(x)) for x in rng.integers(0, 2, n_ph))
        rows.append(f"{path}|spk{i % 4}|{('ZH', 'JP', 'EN')[i % 3]}|text|"
                    f"{' '.join(phones)}|{tones}|{n_ph}")
    filelist = os.path.join(root, "train.list")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(rows))
    config = dict(
        version="2.3",
        train=dict(log_interval=1, eval_interval=100000, seed=1234, epochs=1000,
                   learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9,
                   batch_size=batch_size, bf16_run=bf16_run, lr_decay=0.99995,
                   segment_size=16384, c_mel=45, c_kl=1.0),
        data=dict(training_files=filelist, validation_files=filelist,
                  sampling_rate=sr, filter_length=2048, hop_length=hop,
                  win_length=2048, n_mel_channels=128, mel_fmin=0.0,
                  mel_fmax=None, add_blank=True, n_speakers=256,
                  spk2id={f"spk{i}": i for i in range(4)}),
        model=(V23_MODEL_JSON if slm_dir is None else dict(
            V23_MODEL_JSON, slm=dict(V23_MODEL_JSON["slm"], model=slm_dir))),
    )
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(config, f)
    return cfg_path


TEXT_SENTENCES = {  # three per language; [text] runs ZH only when jieba imports
    "JP": ["こんにちは、今日はいい天気ですね。", "私は日本語を勉強しています。",
           "飛行機が空港に到着した。"],
    "EN": ["The quick brown fox jumps over the lazy dog.",
           "Speech synthesis turns written text into natural sounding audio.",
           "Hello world, this is a test of the engine."],
    "ZH": ["今天天气很好，我们去公园散步吧。", "基于神经网络的语音合成系统能够生成自然流畅的声音。",
           "你好，世界。"],
}
TEXT_BATCH = 8


def write_engine_config(root):
    """config.json (version 2.3, the V2.3 model section, 256 speaker slots of
    which spk2id names 4)
    and G_0.pth from the random model of `make_model`. -> (config, weights)."""
    config = dict(
        version="2.3",
        train=dict(segment_size=16384),
        data=dict(sampling_rate=44100, filter_length=2048, hop_length=512,
                  win_length=2048, n_mel_channels=128, n_speakers=256,
                  spk2id={f"spk{i}": i for i in range(4)}),
        model=V23_MODEL_JSON,
    )
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(config, f)
    sd = make_model("cpu").state_dict()
    weights = os.path.join(root, "G_0.pth")
    torch.save({"model": sd, "iteration": 0}, weights)
    return cfg_path, weights


def run_text(dev, smi, counters):
    """Text in, wave out through the user's entry points: `load_tts_engine`
    from a config.json and a G_0.pth, `warmup`, then `infer` (one JP and one EN
    sentence, ZH too when jieba imports), `infer_multilang` (JP + EN) and
    `infer_batch` of TEXT_BATCH sentences across the languages. Each call is
    one synthesis call: K1 and K2 launch 28 and 3 times in it, counts zeroed
    just before it and read just after. One sentence at zero noise, card
    against CPU (the same file loaded on the CPU). infer_batch timed: host
    time (prepare: g2p + BERT + features) and synthesis time. Returns the
    launches of K1 and K2 summed over the phase's calls."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.infer import load_tts_engine

    try:
        import jieba  # noqa: F401
        langs = ["JP", "EN", "ZH"]
    except ImportError:
        langs = ["JP", "EN"]
        log("[text] jieba does not import on this machine: ZH (g2p through "
            "jieba's segmenter) does not run")
    with tempfile.TemporaryDirectory() as root:
        config, weights = write_engine_config(root)
        t0 = time.perf_counter()
        engine = load_tts_engine(config, weights, device="cuda")
        load_s = time.perf_counter() - t0
        # the CPU side of the card-vs-CPU check: the same files on the CPU
        cpu_engine = load_tts_engine(config, weights, device="cpu",
                                     bert_extractor=engine.bert_extractor)
    cfg = engine.model.cfg
    if cfg != ModelConfig():
        raise AssertionError(f"the loaded config is not the default V2.3 one: {cfg}")
    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
    want = {k: 0 for k in counters}
    want.update(banded_attn_fwd=n_attn, mrf_fwd=n_mrf)
    log(f"[text] load_tts_engine(config.json, G_0.pth) in {load_s:.1f} s; languages "
        f"{langs}; BERT {engine.bert_extractor.describe()} (no BERT weights in the "
        f"checkout: seeded noise, with its warning)")
    totals = {"banded_attn_fwd": 0, "mrf_fwd": 0}

    def call(what, fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        if got != want:
            raise AssertionError(f"[text] {what}: kernel launches {got}, want {want}")
        for k in totals:
            totals[k] += got[k]
        waves = out if isinstance(out, list) else [out]
        for w in waves:
            if not (len(w) >= engine.hop_length and np.isfinite(w).all()
                    and np.abs(w).max() <= 1.0):
                raise AssertionError(f"[text] {what}: a wave is empty, non-finite or "
                                     "out of [-1, 1]")
        log(f"[text] {what}: K1 {got['banded_attn_fwd']} K2 {got['mrf_fwd']} launches; "
            f"{sum(len(w) for w in waves) / engine.sampling_rate:.2f} s of audio")
        return out

    t0 = time.perf_counter()
    n_grid = engine.warmup(batch_sizes=(1, TEXT_BATCH), buckets=(64, 128))
    log(f"[text] warmup: {n_grid} (batch, bucket) points at the worst-case frame cap "
        f"in {time.perf_counter() - t0:.1f} s")
    for i, lang in enumerate(langs):
        call(f"infer {lang}", lambda: engine.infer(
            TEXT_SENTENCES[lang][0], f"spk{i}", language=lang))
    call("infer_multilang JP+EN", lambda: engine.infer_multilang(
        [(TEXT_SENTENCES["JP"][1], "JP"), (TEXT_SENTENCES["EN"][1], "EN")], "spk1"))
    pool = [(TEXT_SENTENCES[lang][k], lang) for k in range(3) for lang in langs]
    pairs = [pool[i % len(pool)] for i in range(TEXT_BATCH)]
    texts, blangs = [t for t, _ in pairs], [la for _, la in pairs]
    speakers = [f"spk{i % 4}" for i in range(TEXT_BATCH)]
    call(f"infer_batch of {TEXT_BATCH} ({blangs})",
         lambda: engine.infer_batch(texts, speakers, language=blangs))

    zero = dict(language="JP", noise_scale=0.0, noise_scale_w=0.0)
    gpu_wave = engine.infer(TEXT_SENTENCES["JP"][0], "spk2", **zero)
    cpu_wave = cpu_engine.infer(TEXT_SENTENCES["JP"][0], "spk2", **zero)
    err = (float(np.abs(gpu_wave - cpu_wave).max()) if len(gpu_wave) == len(cpu_wave)
           else math.inf)
    log(f"[text] one JP sentence, zero noise: frames card "
        f"{len(gpu_wave) // engine.hop_length} cpu {len(cpu_wave) // engine.hop_length}, "
        f"wave max_abs_err {err:.3e} (bound {WAVE_BOUND:g})")
    if len(gpu_wave) != len(cpu_wave) or not err <= WAVE_BOUND:
        raise AssertionError("[text] card and CPU disagree")
    del cpu_engine

    prep = []
    prepare = engine.prepare

    def timed_prepare(*a, **k):
        t = time.perf_counter()
        req = prepare(*a, **k)
        prep.append(time.perf_counter() - t)
        return req

    engine.prepare = timed_prepare
    torch.cuda.reset_peak_memory_stats()
    lat, host = [], []
    for _ in range(TIMED_CALLS):
        prep.clear()
        t0 = time.perf_counter()
        waves = engine.infer_batch(texts, speakers, language=blangs)
        lat.append(time.perf_counter() - t0)
        host.append(sum(prep))
    del engine.prepare
    dev_ms = device_ms(lambda: engine.infer_batch(texts, speakers, language=blangs),
                       iters=3)
    audio_s = sum(len(w) for w in waves) / engine.sampling_rate
    synth = [a - h for a, h in zip(lat, host)]
    med = float(np.median(lat))
    log(f"[text-timing] {smi}: infer_batch of {TEXT_BATCH} sentences, {audio_s:.2f} s "
        f"of audio per call; over {TIMED_CALLS} calls median {med * 1e3:.1f} ms, max "
        f"{max(lat) * 1e3:.1f} ms; host (prepare: clean_text + get_text + BERT noise) "
        f"median {np.median(host) * 1e3:.1f} ms, max {max(host) * 1e3:.1f} ms, "
        f"{np.median(host) * 1e3 / TEXT_BATCH:.2f} ms per sentence; run_prepared median "
        f"{np.median(synth) * 1e3:.1f} ms, max {max(synth) * 1e3:.1f} ms; "
        f"{audio_s / med:.1f} audio-s/s at the median; device time (the profiler's "
        f"kernel time per call) {dev_ms:.1f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del engine
    torch.cuda.empty_cache()
    return totals


STAGE_BOUND = 1e-6  # run_stages / the .pt2 programs vs infer / the live stages, on the card
STAGE_TIMED = 5  # calls timed per stage and per end-to-end path
ONNX_T_X, ONNX_FRAMES = 64, 32  # [onnx]'s bucket (the numpy evaluator loops per sample)
ONNX_BOUND = 1e-3  # the numpy evaluator (fp32) vs the card's stage (3xTF32, TF32 off)


def _k12(counters):
    return counters["banded_attn_fwd"].launches, counters["mrf_fwd"].launches


def _stage_chain(fns, batch, knobs, max_frames, z_sdp, counters):
    """The six stages of `fns` in run_stages' order on the batch, each with
    the counts zeroed just before it and read just after -> (outputs of
    dec, y_lengths, {stage: (K1, K2)}, {stage: its arguments}). fns' sdp
    takes (x_h, x_mask, g, noise_scale_w [b], z)."""
    from bert_vits2_tpu_torch.models.synthesizer import durations, expand_prior

    counts, calls = {}, {}

    def run(name, *args):
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        with torch.inference_mode():
            out = fns[name](*args)
        torch.cuda.synchronize()
        others = {k: c.launches for k, c in counters.items()
                  if k not in ("banded_attn_fwd", "mrf_fwd") and c.launches}
        if others:
            raise AssertionError(f"[stages] {name}: other kernels launched: {others}")
        counts[name], calls[name] = _k12(counters), args
        return out

    b = batch
    g = run("emb", b["sid"])
    x_h, m_p, logs_p, x_mask = run("enc_p", b["x"], b["x_lengths"], b["tone"],
                                   b["language"], b["bert"], b["ja_bert"], b["en_bert"], g)
    logw_sdp = run("sdp", x_h, x_mask, g, knobs["noise_scale_w"], z_sdp)
    logw_dp = run("dp", x_h, x_mask, g)
    with torch.inference_mode():
        w = durations(logw_sdp, logw_dp, x_mask, knobs["sdp_ratio"], knobs["length_scale"])
        z_p, _, y_mask, y_len = expand_prior(w, m_p, logs_p, x_mask, max_frames,
                                             knobs["noise_scale"],
                                             torch.Generator(device="cuda").manual_seed(3))
    z = run("flow", z_p, y_mask[:, None, :], g)
    wave = run("dec", z * y_mask[:, None, :], g, y_mask[:, None, :])
    return wave, y_len, counts, calls


def run_stages_phase(dev, smi, counters):
    """The six inference stages ([stages]): make_stages over the engine's
    flow, decoder and packed MRF weights at the default V2.3 widths, the
    seed-7 batch of 8 at zero noise: run_stages against
    Synthesizer.infer on the card (STAGE_BOUND, equal lengths) and against
    the CPU (WAVE_BOUND); K1 and K2 launches per stage (enc_p 6, flow 16,
    dec K2 3, the rest none); export_stages on the card, torch.export.load,
    each program run once on the same inputs (the same launches, outputs
    equal to the live stages'); each of the six bv2 ops bit-equal to the
    direct launch of its kernel at the main path's shapes; each program's
    and live stage's time (CUDA events and the profiler's kernel time)
    beside infer_stage_flops, run_stages through the programs and through
    the live stages beside run_prepared's median. Returns (the launches of
    the run_stages call and of the programs' chain, the model, the live
    stages)."""
    from bert_vits2_tpu_torch.compat.stages import (
        STAGES, export_stages, load_stages, make_stages, run_stages)
    from bert_vits2_tpu_torch.infer import TTSEngine
    from bert_vits2_tpu_torch.ops import attention, mrf
    from bert_vits2_tpu_torch.utils.flops import infer_stage_flops

    t_phase = time.perf_counter()
    model = make_model("cuda")
    cfg = model.cfg
    engine = TTSEngine(model, device="cuda")
    reqs = [r._replace(noise_scale=0.0, noise_scale_w=0.0)
            for r in make_requests(cfg, MAIN_BATCH, seed=7)]
    frames = engine.predict_frames(reqs)
    m = engine.frame_multiple
    max_frames = max(-(-int(frames.max()) // m) * m, m)
    with torch.inference_mode():
        batch = engine.model_inputs(reqs)
    knobs = {k: batch.pop(k) for k in ("noise_scale", "length_scale", "noise_scale_w",
                                       "sdp_ratio")}
    t_x = batch["x"].shape[1]
    stages = make_stages(model, engine.stages, engine.mrf_packed)
    log(f"[stages] default V2.3 config, the seed-7 batch of {MAIN_BATCH} at zero noise: "
        f"t_x {t_x}, max_frames {max_frames}, predicted frames {sorted(frames.tolist())}")

    def gen():
        return torch.Generator(device=dev).manual_seed(7)

    with torch.inference_mode():
        ref, _, _, y_ref = model.infer(max_frames=max_frames, generator=gen(),
                                       mrf_packed=engine.mrf_packed, stages=engine.stages,
                                       **batch, **knobs)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    wave, y_len = run_stages(stages, max_frames=max_frames, generator=gen(), **batch,
                             **knobs)
    torch.cuda.synchronize()
    run_launches = {k: c.launches for k, c in counters.items()}
    n_enc, n_flow = cfg.n_layers, cfg.n_flow_layer * cfg.n_layers_trans_flow
    want = {k: 0 for k in counters}
    want.update(banded_attn_fwd=n_enc + n_flow, mrf_fwd=3)
    err = (wave - ref).abs().max().item()
    log(f"[stages] run_stages vs Synthesizer.infer on the card: y_lengths "
        f"{y_len.tolist()} vs {y_ref.tolist()}, wave max_abs_err {err:.3e} (bound "
        f"{STAGE_BOUND:g}); launches of the run_stages call: K1 "
        f"{run_launches['banded_attn_fwd']} K2 {run_launches['mrf_fwd']} (want "
        f"{n_enc + n_flow} and 3, no other kernel)")
    if not (torch.equal(y_len, y_ref) and err <= STAGE_BOUND) or run_launches != want:
        raise AssertionError("[stages] run_stages disagrees with infer or launched "
                             f"other kernels: {run_launches}")

    n_cpu = 1
    cpu_model = make_model("cpu", state_dict={k: v.cpu() for k, v in
                                              model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_wave, cpu_len = run_stages(
        make_stages(cpu_model), max_frames=max_frames,
        **{k: v[:n_cpu].cpu() for k, v in {**batch, **knobs}.items()})
    cpu_s = time.perf_counter() - t0
    cpu_err = (wave[:n_cpu].cpu() - cpu_wave).abs().max().item()
    log(f"[stages] {smi}: card vs CPU (the first {n_cpu} item, zero noise): y_lengths "
        f"{cpu_len.tolist()} vs {y_len[:n_cpu].tolist()}, wave max_abs_err "
        f"{cpu_err:.3e} (bound {WAVE_BOUND:g}); CPU run {cpu_s:.1f} s")
    if not (torch.equal(cpu_len, y_len[:n_cpu].cpu()) and cpu_err <= WAVE_BOUND):
        raise AssertionError("[stages] card and CPU disagree")
    del cpu_model

    z_sdp = torch.randn(MAIN_BATCH, 2, t_x, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    live = dict(stages, sdp=lambda x_h, x_mask, g, nsw, z: stages["sdp"](
        x_h, x_mask, g, nsw, z=z))
    live_wave, _, live_counts, calls = _stage_chain(live, batch, knobs, max_frames, z_sdp,
                                                    counters)
    want_counts = {s: (0, 0) for s in STAGES}
    want_counts.update(enc_p=(n_enc, 0), flow=(n_flow, 0), dec=(0, 3))
    log(f"[stages] K1, K2 launches per live stage call: {live_counts}")
    if live_counts != want_counts:
        raise AssertionError(f"[stages] launches per stage {live_counts}, want "
                             f"{want_counts}")

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = export_stages(model, root, t_x=t_x, max_frames=max_frames,
                              batch=MAIN_BATCH, stages=engine.stages,
                              mrf_packed=engine.mrf_packed)
        export_s = time.perf_counter() - t0
        sizes = {k: os.path.getsize(p) / 2**20 for k, p in paths.items()}
        t0 = time.perf_counter()
        progs = load_stages(root)
        load_s = time.perf_counter() - t0
    ops = {k: sorted({str(n.target) for n in p.module.graph.nodes
                      if str(n.target).startswith("bv2.")}) for k, p in progs.items()}
    log(f"[stages] {smi}: export_stages on the card in {export_s:.1f} s, "
        f"torch.export.load of the six in {load_s:.1f} s; .pt2 MiB "
        f"{ {k: round(v, 2) for k, v in sizes.items()} }; bv2 ops in the programs {ops}")
    prog_wave, prog_len, prog_counts, _ = _stage_chain(progs, batch, knobs, max_frames,
                                                       z_sdp, counters)
    prog_err = (prog_wave - live_wave).abs().max().item()
    log(f"[stages] K1, K2 launches per loaded program: {prog_counts}; dec output vs "
        f"the live stages' max_abs_err {prog_err:.3e} (bound {STAGE_BOUND:g})")
    if prog_counts != want_counts or not prog_err <= STAGE_BOUND:
        raise AssertionError("[stages] the loaded programs launch otherwise or disagree")
    for name in STAGES:
        a, b_ = (o if isinstance(o, tuple) else (o,) for o in (
            live[name](*calls[name]), progs[name](*calls[name])))
        e = max((x - y).abs().max().item() for x, y in zip(a, b_))
        if not e <= STAGE_BOUND:
            raise AssertionError(f"[stages] program {name} max_abs_err {e}")
    prog_launches = {"banded_attn_fwd": sum(c[0] for c in prog_counts.values()),
                     "mrf_fwd": sum(c[1] for c in prog_counts.values())}

    # each bv2 op against the direct launch of its kernel, at the main path's
    # shapes: K1 at the flow's [8, 2, max_frames, 96] (bf16 and the wide
    # variant too), K2 at the decoder's three stages
    g = torch.Generator(device=dev).manual_seed(9)
    d = cfg.hidden_channels // cfg.n_heads
    att = [torch.randn(MAIN_BATCH, cfg.n_heads, max_frames, d, device=dev, generator=g)
           * d ** -0.5 for _ in range(3)]
    mask = (torch.arange(max_frames, device=dev)[None] < y_len[:, None]).float()
    tables = [torch.randn(9, d, device=dev, generator=g) * d ** -0.5 for _ in range(2)]
    bit = {}
    for name, direct, dt in (("banded_attn_fwd", attention.banded_attention_fwd, None),
                             ("banded_attn_fwd_bf16", attention.banded_attention_fwd_bf16,
                              torch.bfloat16),
                             ("banded_attn_wide_fwd", attention.wide_fwd, None),
                             ("banded_attn_wide_fwd_bf16", attention.wide_fwd_bf16,
                              torch.bfloat16)):
        ts = [a.to(dt) if dt else a for a in att] + [mask.to(dt) if dt else mask] + [
            t.to(dt) if dt else t for t in tables]
        with torch.inference_mode():
            via_op = getattr(torch.ops.bv2, name)(*ts, 4)
            ref_out = direct(tuple(ts), 4)
        bit[name] = torch.equal(via_op, ref_out)
    for i, packed in enumerate(engine.mrf_packed):
        if packed is None:
            continue
        up = int(np.prod(cfg.upsample_rates[:i + 1]))
        x = torch.randn(MAIN_BATCH, packed.channels, max_frames * up, device=dev,
                        generator=g)
        mk = mask.repeat_interleave(up, dim=1).contiguous()
        for name, direct, dt in (("mrf_fwd", mrf.mrf_fwd, torch.float32),
                                 ("mrf_fwd_bf16", mrf.mrf_fwd_bf16, torch.bfloat16)):
            wts = packed if dt == torch.float32 else mrf.prepare_mrf_weights(
                model.dec._stage_blocks(i), dt)
            xs, ms = x.to(dt), mk.to(dt)
            with torch.inference_mode():
                via_op = getattr(torch.ops.bv2, name)(xs, ms, *wts.op_args)
                ref_out = direct(xs, ms, wts)
            bit[f"{name} C={packed.channels}"] = torch.equal(via_op, ref_out)
    log(f"[stages] each bv2 op bit-equal to the direct launch of its kernel: {bit}")
    if not all(bit.values()):
        raise AssertionError(f"[stages] an op differs from its kernel's launch: {bit}")

    fl = infer_stage_flops(cfg, MAIN_BATCH, t_x, max_frames)
    for name in STAGES:
        a = calls[name]
        p_ms = cuda_ms(lambda: progs[name](*a), iters=STAGE_TIMED)
        p_dev = device_ms(lambda: progs[name](*a), iters=3)
        with torch.inference_mode():
            l_ms = cuda_ms(lambda: live[name](*a), iters=STAGE_TIMED)
            l_dev = device_ms(lambda: live[name](*a), iters=3)
        log(f"[stages-timing] {smi}: {name}: program {p_ms:.3f} ms (device {p_dev:.3f} "
            f"ms), live stage {l_ms:.3f} ms (device {l_dev:.3f} ms); "
            f"{fl[name] / 1e9:.2f} GFLOP (utils/flops.py), "
            f"{fl[name] / max(p_dev, 1e-9) / 1e9:.1f} TFLOP/s at the program's device time")

    def prog_sdp(x_h, x_mask, g_, nsw, generator=None, z=None):
        from bert_vits2_tpu_torch.models.synthesizer import sdp_noise
        return progs["sdp"](x_h, x_mask, g_, nsw,
                            z if z is not None else sdp_noise(x_h, 1.0, generator))

    prog_stages = dict(progs, sdp=prog_sdp)
    paths_timed = {}
    for label, fn in (("run_stages (programs)", lambda: run_stages(
            prog_stages, max_frames=max_frames, generator=gen(), **batch, **knobs)),
                      ("run_stages (live stages)", lambda: run_stages(
            stages, max_frames=max_frames, generator=gen(), **batch, **knobs)),
                      ("run_prepared", lambda: engine.run_prepared(reqs))):
        fn()
        torch.cuda.synchronize()
        lat = []
        for _ in range(STAGE_TIMED):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        paths_timed[label] = (float(np.median(lat)) * 1e3,
                              device_ms(fn, iters=2))
    log(f"[stages-timing] {smi}: batch {MAIN_BATCH}, t_x {t_x}, max_frames {max_frames}: "
        + "; ".join(f"{k} median {v[0]:.1f} ms over {STAGE_TIMED} calls (device "
                    f"{v[1]:.1f} ms)" for k, v in paths_timed.items())
        + " (run_prepared adds its duration pass and host batching)")
    log(f"[stages] {smi}: phase {time.perf_counter() - t_phase:.1f} s")
    del engine
    return run_launches, prog_launches, model, stages


def run_onnx_phase(dev, smi, model, stages):
    """ONNX export ([onnx]): the six graphs of the [stages] model, exported
    on the CPU (compat/onnx_export.py: torch.export of float32 copies with
    weight norm resolved, the plain functions in place of the kernels) at
    the bucket (ONNX_T_X, ONNX_FRAMES); each checked by
    compat/onnx_check.py and evaluated by the numpy evaluator on
    verify_onnx's random inputs against the card's live stage on the same
    inputs (ONNX_BOUND); file sizes and the phase's seconds."""
    from bert_vits2_tpu_torch.compat.onnx_check import check_model
    from bert_vits2_tpu_torch.compat.onnx_eval import OnnxEvaluator
    from bert_vits2_tpu_torch.compat.onnx_export import (
        STAGES, export_onnx, make_onnx_stage_fns, random_stage_inputs)

    t_phase = time.perf_counter()
    cfg = model.cfg
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fns = make_onnx_stage_fns(model)
        paths = export_onnx(model, root, "BertVits2.3PT", ONNX_T_X, ONNX_FRAMES, fns=fns)
        export_s = time.perf_counter() - t0
        graphs = {k: open(p, "rb").read() for k, p in paths.items()}
    del fns
    inputs = random_stage_inputs(cfg, ONNX_T_X, ONNX_FRAMES, seed=0)

    def card(stage, args):
        a = [torch.from_numpy(x).to(dev) for x in args]
        with torch.inference_mode():
            if stage == "emb":
                out = stages["emb"](a[0])
            elif stage == "enc_p":
                out = stages["enc_p"](*a[:4], *(b[None] for b in a[4:7]), a[7][..., 0])
            elif stage == "sdp":
                out = stages["sdp"](a[0], a[1], a[3][..., 0], 1.0, z=a[2])
            elif stage == "dp":
                out = stages["dp"](a[0], a[1], a[2][..., 0])
            elif stage == "flow":
                out = stages["flow"](a[0], a[1], a[2][..., 0])
            else:
                ones = torch.ones(1, 1, a[0].shape[2], device=dev)
                out = stages["dec"](a[0], a[1][..., 0], ones)[:, None, :]
        return [o.cpu().numpy() for o in (out if isinstance(out, tuple) else (out,))]

    rows = []
    for stage in STAGES:
        issues = check_model(graphs[stage])
        t0 = time.perf_counter()
        got = OnnxEvaluator(graphs[stage])(*inputs[stage])
        eval_s = time.perf_counter() - t0
        want = card(stage, inputs[stage])
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        rows.append((stage, len(graphs[stage]) / 2**20, issues, err, eval_s))
        if issues or not err <= ONNX_BOUND:
            raise AssertionError(f"[onnx] {stage}: checker {issues[:3]}, max_abs_err "
                                 f"{err} (bound {ONNX_BOUND:g})")
    log(f"[onnx] {smi}: six graphs of the default V2.3 model at t_x {ONNX_T_X}, max_frames "
        f"{ONNX_FRAMES}, exported on the CPU in {export_s:.1f} s: "
        + "; ".join(f"{s} {mb:.2f} MiB, conformant, evaluator vs card max_abs_err "
                    f"{e:.3e} (evaluated in {t:.1f} s)" for s, mb, _, e, t in rows)
        + f" (bound {ONNX_BOUND:g}); phase {time.perf_counter() - t_phase:.1f} s")


def log_mel(waves, dev):
    """The training's log-mel (n_fft 2048, hop 512, 128 bins at 44.1 kHz)
    of each wave, on the card."""
    from bert_vits2_tpu_torch.ops.stft import mel_spectrogram
    return [mel_spectrogram(torch.from_numpy(w).to(dev)[None], 2048, 128, 44100, 512,
                            2048, 0.0, None)[0] for w in waves]


def device_groups(evs) -> collections.Counter:
    """Device time (us) of a profile's kernels by group: the banded
    attention kernels, K2, K3, cuDNN's and cuBLAS's convs and GEMMs, and the
    rest."""
    groups = collections.Counter()
    for e in evs:
        key = e.key.lower()
        group = ("K1/B5/B6 (banded attention)" if "banded_attn" in key or
                 "attn_bwd" in key or "band_tables" in key
                 else "K2" if "mrf_kernel" in key else "K3" if "mas_kernel" in key
                 else "convs and GEMMs (cuDNN, cuBLAS)" if any(
                     s_ in key for s_ in ("conv", "cudnn", "xmma", "gemm", "sm90",
                                          "cutlass", "implicit"))
                 else "other (elementwise, copies, reductions)")
        groups[group] += e.self_device_time_total
    return groups


def run_bf16(dev, smi, counters):
    """bf16 serving ([bf16]): K1's bf16 mode at the flow's shape, the wide
    forward's at one [attention-range] shape and K2's at C = 64, 32, 16,
    each against its plain bf16 version; a bf16 MultiHeadAttention of
    d = 160 card against CPU (the wide bf16 kernel's route); then one
    config.json and G_0.pth loaded by load_tts_engine as float32 and as
    bfloat16 (identical state_dicts), the seed-7 batch of MAIN_BATCH
    through run_prepared on both in turns (F B B F, BF16_ROUNDS rounds):
    medians and max, peak memory, K1/K2 launches per call (fp32 28 and 3;
    bf16 12 fp32 + 16 bf16 K1 and 3 bf16 K2), y_lengths equal, the bf16
    waves against the fp32 ones (max-abs error, log-mel L1), a profile of
    one call each. Returns (kernel rows by name, launches by name)."""
    from bert_vits2_tpu_torch.infer import load_tts_engine
    from bert_vits2_tpu_torch.models.synthesizer import cast_copy
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention

    bf16 = torch.bfloat16
    design = lambda f, n: bound_bf16(f, n)[0]  # noqa: E731
    rows = {"banded_attn_fwd_bf16": check_attention(
                dev, (("flow", MAIN_BATCH, 2, FRAMES, 96, 4, N_FLOW_ATTN),), "K1",
                design, bf16),
            "banded_attn_wide_fwd_bf16": check_attention(
                dev, range_cases()[:1], "K1-wide", design, bf16),
            "mrf_fwd_bf16": check_mrf(dev, bf16)}
    torch.cuda.empty_cache()

    # the wide kernel's bf16 route through the module (d = 160)
    channels, heads, window = RANGE_MODULES[0]
    torch.manual_seed(channels)
    mod = MultiHeadAttention(channels, channels, heads, window_size=window).eval()
    cpu, gpu = cast_copy(mod, bf16), cast_copy(mod, bf16).to(dev)
    x = torch.randn(len(RANGE_LENS), channels, RANGE_T).to(bf16)
    m = lens_mask(RANGE_LENS, RANGE_T, "cpu")[:, None, :]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with torch.inference_mode():
        got = gpu(x.to(dev), m.to(dev)).float().cpu() * m
        torch.cuda.synchronize()
        wide_launches = {k: fn.launches for k, fn in counters.items()}
        want = cpu(x, m).float() * m
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = K1_BF16_ULPS * bf16_ulp(scale)
    log(f"[bf16] MultiHeadAttention({channels}, {heads} head, window {window}) in "
        f"bf16, [b={len(RANGE_LENS)}, t={RANGE_T}]: card vs CPU max_abs_err "
        f"{err:.3e} (bound {tol:g}: {K1_BF16_ULPS} bf16 ulps of {scale:.3f}); "
        f"launches {wide_launches}")
    want_wide = {k: 0 for k in counters}
    want_wide["banded_attn_wide_fwd_bf16"] = 1
    if wide_launches != want_wide or not err <= tol:
        raise AssertionError("[bf16] the bf16 module outside the tensor-core range")

    with tempfile.TemporaryDirectory() as root:
        config, weights = write_engine_config(root)
        t0 = time.perf_counter()
        engines = {dt: load_tts_engine(config, weights, device="cuda", compute_dtype=dt)
                   for dt in ("float32", "bfloat16")}
        load_s = time.perf_counter() - t0
    f32, b16 = engines["float32"], engines["bfloat16"]
    sd_f, sd_b = f32.model.state_dict(), b16.model.state_dict()
    if sd_f.keys() != sd_b.keys() or not all(torch.equal(sd_f[k], sd_b[k]) for k in sd_f):
        raise AssertionError("[bf16] the two engines' state_dicts differ")
    cfg = b16.model.cfg
    reqs = make_requests(cfg, MAIN_BATCH, seed=7)
    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    want = {"float32": dict(banded_attn_fwd=n_attn, mrf_fwd=3),
            "bfloat16": dict(banded_attn_fwd=2 * cfg.n_layers,
                             banded_attn_fwd_bf16=N_FLOW_ATTN, mrf_fwd_bf16=3)}
    log(f"[bf16] load_tts_engine(config.json, G_0.pth, compute_dtype=...) float32 and "
        f"bfloat16 in {load_s:.1f} s; identical state_dicts ({len(sd_f)} tensors); "
        f"flow and dec copies in bf16: "
        f"{sorted({str(p.dtype) for st in b16.stages for p in st.parameters()})}")
    out, lat, peak, launches = {}, {"float32": [], "bfloat16": []}, {}, {}
    for name, eng in engines.items():
        eng.run_prepared(reqs)  # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        out[name] = eng.run_prepared(reqs)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        w_ = {k: 0 for k in counters}
        w_.update(want[name])
        log(f"[bf16] {name} run_prepared: launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != w_:
            raise AssertionError(f"[bf16] {name}: kernel launches {got}, want {w_}")
        launches[name] = got
        for w in out[name]:
            if not (len(w) >= eng.hop_length and np.isfinite(w).all()
                    and np.abs(w).max() <= 1.0):
                raise AssertionError(f"[bf16] {name}: a wave is empty, non-finite or "
                                     "out of [-1, 1]")
    lens_f = [len(w) // f32.hop_length for w in out["float32"]]
    lens_b = [len(w) // b16.hop_length for w in out["bfloat16"]]
    if lens_f != lens_b:
        raise AssertionError(f"[bf16] y_lengths differ: {lens_f} {lens_b}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(out["float32"], out["bfloat16"]))
    rms = float(np.sqrt(np.mean(np.concatenate(out["float32"]) ** 2)))
    mel_l1, mel_l1_60 = [], []
    with torch.inference_mode():
        for a, b in zip(log_mel(out["float32"], dev), log_mel(out["bfloat16"], dev)):
            mel_l1.append((a - b).abs().mean().item())
            floor = a.max() - math.log(1000.0)  # 60 dB below the peak magnitude
            mel_l1_60.append((a.clamp(min=floor) - b.clamp(min=floor)).abs().mean().item())
    log(f"[bf16] y_lengths equal ({lens_f} frames); bf16 against float32 waves: "
        f"max_abs_err {err:.3e} (fp32 wave rms {rms:.3e}), log-mel L1 "
        f"{np.mean(mel_l1):.4f}, within 60 dB of each peak {np.mean(mel_l1_60):.4f} "
        f"(n_fft 2048, hop 512, 128 bins, natural log of magnitude, mean over the "
        f"{MAIN_BATCH} requests)")

    for _ in range(BF16_ROUNDS):
        for name in ("float32", "bfloat16", "bfloat16", "float32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].run_prepared(reqs)
            torch.cuda.synchronize()
            lat[name].append(time.perf_counter() - t0)
    for name, eng in engines.items():
        torch.cuda.reset_peak_memory_stats()
        eng.run_prepared(reqs)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    audio_s = sum(len(w) for w in out["float32"]) / f32.sampling_rate
    med = {k: float(np.median(v)) for k, v in lat.items()}
    log(f"[bf16-timing] {smi}: run_prepared batch {MAIN_BATCH}, {audio_s:.2f} s of "
        f"audio, {2 * BF16_ROUNDS} calls each in turns (F B B F): float32 median "
        f"{med['float32'] * 1e3:.1f} ms, max {max(lat['float32']) * 1e3:.1f}; bfloat16 "
        f"median {med['bfloat16'] * 1e3:.1f} ms, max {max(lat['bfloat16']) * 1e3:.1f} "
        f"(bf16 / fp32 {med['bfloat16'] / med['float32']:.3f}); peak memory float32 "
        f"{peak['float32']:.2f} GiB, bfloat16 {peak['bfloat16']:.2f} GiB")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the C >= 128 vocoder stages (those K2 does not take): their convs'
    # inputs have the channels of these stages and more samples than text
    t_x = f32._bucket(max(len(r.inputs[0]) for r in reqs))
    stage_ch = {cfg.upsample_initial_channel >> (i + k)
                for i, packed in enumerate(b16.mrf_packed) if packed is None
                for k in (0, 1)}
    for name, eng in engines.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            eng.run_prepared(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs, dev_us = profile_lines(prof, wall, f"[bf16] one {name} run_prepared")
        stage_us = sum(e.device_time_total
                       for e in prof.key_averages(group_by_input_shape=True)
                       if e.key == "aten::convolution" and e.input_shapes
                       and len(e.input_shapes[0]) == 3
                       and e.input_shapes[0][1] in stage_ch
                       and e.input_shapes[0][2] > t_x)
        log(f"[bf16] {name}: the C >= 128 vocoder stages' convolutions (inputs of "
            f"{sorted(stage_ch)} channels; cuDNN's kernels with its layout "
            f"conversions) {stage_us / 1e3:.2f} ms of device time "
            f"({100 * stage_us / dev_us:.1f}%)")
        groups = device_groups(evs)
        log(f"[bf16] {name} device time by group: " + "; ".join(
            f"{g_} {us / 1e3:.2f} ms ({100 * us / dev_us:.1f}%)"
            for g_, us in groups.most_common()))
    del engines, f32, b16
    torch.cuda.empty_cache()
    bf16_launches = {k: launches["bfloat16"][k] for k in ("banded_attn_fwd_bf16",
                                                            "mrf_fwd_bf16")}
    bf16_launches["banded_attn_wide_fwd_bf16"] = wide_launches["banded_attn_wide_fwd_bf16"]
    return rows, bf16_launches


VERSION_CASES = (  # name, config.json version, model-section additions, text languages
    ("1.0", "1.0.1", {}, ()),  # ZH only: seeded ids through run_prepared (jieba)
    ("1.1", "1.1.1", {}, ("JP",)),
    ("2.0", "2.0.2-fix", {}, ("JP", "EN")),
    ("2.1", "2.1", {}, ("JP", "EN")),
    ("2.2", "2.2", {}, ("JP", "EN")),
    ("2.3 vits1 flow", "2.3", {"use_transformer_flow": False}, ("JP", "EN")),
    ("2.3", "2.3", {}, ("JP", "EN")),  # the reference for the times
)
VERSION_TIMED = 5  # infer calls timed per family


class StubEmotion:
    """Seeded vectors in place of the wav2vec2 / CLAP extractors (no weights
    in the checkout), one per (reference audio, prompt)."""

    def __init__(self, dim):
        self.dim = dim

    def __call__(self, reference_audio=None, prompt=None):
        key = sum(map(ord, repr((reference_audio, prompt))))
        return np.random.default_rng(key).normal(size=self.dim).astype(np.float32)


def write_family(root, name, version, model_add):
    """config.json of `version` (the V2.3 model section plus `model_add`) and
    a reference-layout G_0.pth of a nonzero-init model of the family's
    config; the V2.1/V2.2 quantizers' EMA buffers (training state) are in
    the file. -> (config path, weights path, ModelConfig, state_dict, the
    number of EMA buffers added)."""
    from bert_vits2_tpu_torch.compat.versions import spec_for
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models import build_synthesizer
    config = dict(
        version=version, train=dict(segment_size=16384),
        data=dict(sampling_rate=44100, filter_length=2048, hop_length=512,
                  win_length=2048, n_mel_channels=128, n_speakers=256,
                  spk2id={f"spk{i}": i for i in range(4)}),
        model=dict(V23_MODEL_JSON, **model_add))
    # [text] holds V23_MODEL_JSON to ModelConfig()'s V2.3 widths
    cfg = ModelConfig.from_json(config["model"], config["data"], segment_size=16384,
                                **spec_for(version).model_overrides())
    model = build_synthesizer(cfg, device="cpu", seed=0)
    nonzero_init(model)
    with torch.no_grad():
        model.dp.proj.bias.fill_(1.5)
    sd = model.state_dict()
    saved = dict(sd)  # + the quantizers' EMA buffers, as vector_quantize_pytorch keeps them
    for key in [k for k in sd if k.endswith("._codebook.embed")]:
        stem = key[:-len("embed")]
        heads, size = sd[key].shape[:2]
        saved[stem + "initted"] = torch.ones(1)
        saved[stem + "cluster_size"] = torch.ones(heads, size)
        saved[stem + "embed_avg"] = sd[key].clone()
    tag = name.replace(" ", "_")
    weights = os.path.join(root, f"G_{tag}.pth")
    torch.save({"model": saved, "iteration": 0}, weights)
    cfg_path = os.path.join(root, f"config_{tag}.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(config, f)
    return cfg_path, weights, cfg, sd, len(saved) - len(sd)


def run_versions(dev, smi, counters):
    """[versions]: every version family of compat/versions.py at the V2.3
    widths through load_tts_engine on the card, from a config.json and a
    reference-layout G_0.pth (the V2.1/V2.2 quantizers' EMA buffers in the
    file, dropped by the loader): 1.0 (ZH only: seeded ids through
    run_prepared, its g2p needs jieba), 1.1 (JP), 2.0, 2.1 (emotion=3 and a
    stub 1024-d vector for reference audio), 2.2 (zero CLAP features and a
    stub 512-d vector), a 2.3 config with use_transformer_flow false (the vits1 WN
    flow) and the 2.3 engine itself (JP and EN from text). Each call's K1
    and K2 launches (counts zeroed just before it): 28 and 3 with the
    transformer flow, 12 and 3 with the vits1 flow. One zero-noise call per
    emotion input, card against the CPU engine of the same files, within
    WAVE_BOUND. The median of the first call (infer JP; 1.0: its
    run_prepared) of each family beside the 2.3 engine's infer JP, and per
    second of audio (each family's random model predicts other durations);
    the emotion branch alone on the card. Returns K1's and K2's launches
    summed over the phase's checked calls."""
    from bert_vits2_tpu_torch.infer import load_tts_engine
    from bert_vits2_tpu_torch.infer.loader import _pth_state_dict

    totals = {"banded_attn_fwd": 0, "mrf_fwd": 0}
    medians, per_audio = {}, {}
    t_phase = time.perf_counter()
    sentence = {"JP": TEXT_SENTENCES["JP"][0], "EN": TEXT_SENTENCES["EN"][2]}
    with tempfile.TemporaryDirectory() as root:
        for name, version, model_add, langs in VERSION_CASES:
            config, weights, cfg, sd, n_ema = write_family(root, name, version, model_add)
            stub = StubEmotion({"vq210": 1024, "clap220": 512}.get(cfg.emotion, 0))
            t0 = time.perf_counter()
            engine = load_tts_engine(config, weights, device="cuda", emotion_extractor=stub)
            load_s = time.perf_counter() - t0
            if engine.model.cfg != cfg:
                raise AssertionError(f"[versions] {name}: loaded {engine.model.cfg}, not {cfg}")
            got_sd = engine.model.state_dict()
            if set(_pth_state_dict(weights)) != set(got_sd) or not all(
                    torch.equal(got_sd[k].cpu(), v) for k, v in sd.items()):
                raise AssertionError(f"[versions] {name}: the loaded weights are not the "
                                     "file's, or the EMA buffers were not dropped")
            emos = {"vq210": [dict(emotion=3), dict(reference_audio="stub.wav")],
                    "clap220": [{}, dict(reference_audio="stub.wav")]}.get(cfg.emotion, [{}])
            n_attn = 2 * cfg.n_layers + (cfg.n_flow_layer * cfg.n_layers_trans_flow
                                         if cfg.use_transformer_flow else 0)
            n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
            want = {k: 0 for k in counters}
            want.update(banded_attn_fwd=n_attn, mrf_fwd=n_mrf)
            if langs:
                calls = [(f"infer {lang} {emo or ''}".strip(),
                          lambda lang=lang, emo=emo: engine.infer(
                              sentence[lang], "spk1", language=lang, **emo))
                         for lang in langs for emo in emos]
                zero = [lambda eng, emo=emo: eng.infer(sentence[langs[0]], "spk1",
                                                       language=langs[0], noise_scale=0.0,
                                                       noise_scale_w=0.0, **emo)
                        for emo in emos]
            else:
                reqs = [r._replace(noise_scale=0.0, noise_scale_w=0.0)
                        for r in make_requests(cfg, 2, seed=3)]
                calls = [("run_prepared of 2 seeded requests",
                          lambda: engine.run_prepared(reqs))]
                zero = [lambda eng: eng.run_prepared(reqs[:1])[0]]
            for what, fn in calls:
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                out = fn()
                torch.cuda.synchronize()
                got = {k: c.launches for k, c in counters.items()}
                if got != want:
                    raise AssertionError(f"[versions] {name} {what}: kernel launches "
                                         f"{got}, want {want}")
                for k in totals:
                    totals[k] += got[k]
                for w in (out if isinstance(out, list) else [out]):
                    if not (len(w) >= engine.hop_length and np.isfinite(w).all()
                            and np.abs(w).max() <= 1.0):
                        raise AssertionError(f"[versions] {name} {what}: a wave is "
                                             "empty, non-finite or out of [-1, 1]")
                log(f"[versions] {name} {what}: K1 {got['banded_attn_fwd']} K2 "
                    f"{got['mrf_fwd']} launches")
            errs = []
            if name != "2.3":  # the 2.3 engine's card-vs-CPU check is [text]'s
                cpu_engine = load_tts_engine(config, weights, device="cpu",
                                             bert_extractor=engine.bert_extractor,
                                             emotion_extractor=stub)
                for fn in zero:
                    g, c = fn(engine), fn(cpu_engine)
                    errs.append(float(np.abs(g - c).max()) if len(g) == len(c)
                                else math.inf)
                del cpu_engine
                if not all(e <= WAVE_BOUND for e in errs):
                    raise AssertionError(f"[versions] {name}: card and CPU disagree: {errs}")
            lat = []
            for _ in range(VERSION_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = calls[0][1]()
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            medians[name] = float(np.median(lat)) * 1e3
            audio_s = sum(len(w) for w in (out if isinstance(out, list) else [out])
                          ) / engine.sampling_rate
            per_audio[name] = medians[name] / audio_s
            branch = ""
            if cfg.emotion != "none":  # the emotion branch alone, batch 1
                enc = engine.model.enc_p
                inputs = {"vq210": {"index": torch.tensor([3], device=dev),
                                    "vector": torch.randn(1, 1024, device=dev)},
                          "clap220": {"feature": torch.randn(1, 512, device=dev)}}
                with torch.inference_mode():
                    branch = "; the emotion branch (" + ", ".join(
                        f"{k}: {cuda_ms(lambda e=e: enc.emotion_embedding(e)):.4f} ms, "
                        f"device {device_ms(lambda e=e: enc.emotion_embedding(e)):.4f}"
                        for k, e in inputs[cfg.emotion].items()) + ")"
            log(f"[versions] {name} (config version {version}{', ' if model_add else ''}"
                f"{json.dumps(model_add) if model_add else ''}): load {load_s:.1f} s, "
                f"{n_ema} EMA buffers dropped; K1 {n_attn} K2 {n_mrf} per call; card vs CPU "
                f"max_abs_err {', '.join(f'{e:.3e}' for e in errs) or 'see [text]'} "
                f"(bound {WAVE_BOUND:g}); {calls[0][0]} median {medians[name]:.1f} ms, "
                f"max {max(lat) * 1e3:.1f} ms over {VERSION_TIMED}, {audio_s:.2f} s of "
                f"audio: {medians[name] / audio_s:.1f} ms per audio-second{branch}")
            del engine
            torch.cuda.empty_cache()
    log(f"[versions-timing] {smi}: median ms of each family's timed call, and ms "
        f"per audio-second, beside the 2.3 engine's {medians['2.3']:.1f} and "
        f"{per_audio['2.3']:.1f}: "
        + ", ".join(f"{k} {v:.1f} / {per_audio[k]:.1f} ({per_audio[k] / per_audio['2.3']:.2f}x)"
                    for k, v in medians.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return totals


SERVE_LEVELS = (1, 4, 16)  # client threads sending at once
SERVE_REQUESTS = 32  # /voice requests per level
SERVE_PARAGRAPHS = {  # four sentences each; EN: 65-128 tokens, one bucket
    "EN": ["The quick brown fox jumps over the lazy dog.",
           "Speech synthesis turns written text into natural sounding audio.",
           "Good morning, everyone, and welcome to the show.",
           "The weather today is sunny with a light breeze from the west."],
    "JP": ["私は日本語を勉強しています。", "ありがとうございました、またお会いしましょう。",
           "駅の近くに新しい本屋ができました。", "飛行機が空港に到着した。"],
}
# kana and Latin only: classify_language sends Han characters to ZH, and
# jieba (ZH's g2p) may not import
SERVE_AUTO = "こんにちは、おげんきですか。Hello world, this is a test of the engine."
SERVE_MIX = ("[spk0]<JP>こんにちは、おげんきですか。<EN>Hello world."
             "[spk1]<EN>Good morning, everyone, and welcome to the show.")
CLI_TIMEOUT_S = 300


def serve_traffic() -> list[dict]:
    """The SERVE_REQUESTS /voice bodies of one level, at the server's default
    knobs: every eighth an auto_split paragraph (EN, JP in turns), one AUTO
    and one MIX request, the rest single JP and EN sentences."""
    pool = [(TEXT_SENTENCES[lang][k], lang) for k in range(3) for lang in ("JP", "EN")]
    out = []
    for i in range(SERVE_REQUESTS):
        if i % 8 == 0:
            lang = ("EN", "JP")[i // 8 % 2]
            body = dict(text="\n".join(SERVE_PARAGRAPHS[lang]), language=lang,
                        auto_split=True)
        elif i == 1:
            body = dict(text=SERVE_AUTO, language="AUTO")
        elif i == 2:
            body = dict(text=SERVE_MIX, language="MIX")
        else:
            text, lang = pool[i % len(pool)]
            body = dict(text=text, language=lang)
        out.append(dict(body, model_id=0, speaker_name=f"spk{i % 4}"))
    return out


def http_json(url, body=None):
    """GET url (body None) or POST body as JSON -> (content type, bytes)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers["Content-Type"], r.read()


def wav_pcm(ctype, body, sampling_rate):
    from scipy.io import wavfile

    if ctype != "audio/wav" or body[:4] != b"RIFF":
        raise AssertionError(f"/voice answered {ctype} {body[:64]!r}")
    sr, pcm = wavfile.read(io.BytesIO(body))
    if sr != sampling_rate or pcm.dtype != np.int16 or not len(pcm):
        raise AssertionError(f"/voice: a WAV of {len(pcm)} {pcm.dtype} samples at {sr} Hz")
    return pcm


def run_serve(smi, counters):
    """The HTTP server in process: traffic at SERVE_LEVELS concurrency through
    the micro-batcher into run_prepared, then the checks (a)-(d). Returns the
    launches of K1 and K2 over the phase (counts zeroed before its traffic)."""
    from bert_vits2_tpu_torch.serve import ModelRegistry
    from bert_vits2_tpu_torch.serve.server import TTSService, engine_loader, make_server
    from bert_vits2_tpu_torch.utils.audio import float_to_int16

    with tempfile.TemporaryDirectory() as root:
        config, weights = write_engine_config(root)
        registry = ModelRegistry(loader=engine_loader("cuda"))
        t0 = time.perf_counter()
        registry.init_model(weights, config)
        load_s = time.perf_counter() - t0
    engine = registry.get(0)
    cfg = engine.model.cfg
    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
    t0 = time.perf_counter()
    n_grid = engine.warmup(batch_sizes=(1, 4, 16), buckets=(64, 128))
    log(f"[serve] load_tts_engine through the server's loader in {load_s:.1f} s; warmup "
        f"of {n_grid} (batch, bucket) points in {time.perf_counter() - t0:.1f} s")
    srv = make_server(registry, "127.0.0.1", 0)
    service = srv.RequestHandlerClass.service
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sr = engine.sampling_rate
    try:
        traffic = serve_traffic()

        def send(body):
            t = time.perf_counter()
            pcm = wav_pcm(*http_json(url + "/voice", body), sr)
            return time.perf_counter() - t, len(pcm) / sr

        def burst(bodies, concurrency):
            t = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
                out = list(pool.map(send, bodies))
            return time.perf_counter() - t, out

        send(traffic[3])  # the server's first request: batcher thread, handler path
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        totals = {"banded_attn_fwd": 0, "mrf_fwd": 0}
        batcher = service._batchers[id(engine)]
        for level in SERVE_LEVELS:
            n0 = len(batcher.batch_sizes)
            before = {k: counters[k].launches for k in totals}
            torch.cuda.reset_peak_memory_stats()
            wall, out = burst(traffic, level)
            torch.cuda.synchronize()
            sizes = batcher.batch_sizes[n0:]
            got = {k: counters[k].launches - before[k] for k in totals}
            want = {"banded_attn_fwd": n_attn * len(sizes), "mrf_fwd": n_mrf * len(sizes)}
            lat = np.array([o[0] for o in out]) * 1e3
            audio_s = sum(o[1] for o in out)
            log(f"[serve] {smi}: concurrency {level}, {len(out)} requests "
                f"({sum(sizes)} utterances) in {wall:.3f} s: "
                f"{len(out) / wall:.2f} requests/s, {audio_s / wall:.1f} audio-s/s "
                f"({audio_s:.1f} s of audio); latency p50 {np.percentile(lat, 50):.1f} ms, "
                f"p95 {np.percentile(lat, 95):.1f} ms, max {lat.max():.1f} ms; "
                f"{len(sizes)} device calls, batch sizes "
                f"{dict(sorted(collections.Counter(sizes).items()))} (mean "
                f"{np.mean(sizes):.2f}); peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 "
                f"{got['banded_attn_fwd']} K2 {got['mrf_fwd']} launches")
            if got != want:
                raise AssertionError(f"[serve] concurrency {level}: launches {got}, want "
                                     f"{n_attn} and {n_mrf} per device call: {want}")
            for k in totals:
                totals[k] += got[k]

        from torch.profiler import ProfilerActivity, profile
        n0 = len(batcher.batch_sizes)
        before = {k: counters[k].launches for k in totals}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall, _ = burst(traffic[:16], 16)
            torch.cuda.synchronize()
        sizes = batcher.batch_sizes[n0:]
        for k in totals:
            totals[k] += counters[k].launches - before[k]
        calls = len(batcher.batch_sizes) - 1  # the first request's call came before
        if totals != {"banded_attn_fwd": n_attn * calls, "mrf_fwd": n_mrf * calls}:
            raise AssertionError(f"[serve] launches {totals} over {calls} device calls")
        profile_lines(prof, wall, f"[serve] {smi}: one burst of 16 requests at "
                      f"concurrency 16 ({len(sizes)} device calls, batch sizes {sizes})",
                      top=6)
        log(f"[serve] {smi}: launches over the phase's traffic: K1 "
            f"{totals['banded_attn_fwd']}, K2 {totals['mrf_fwd']} in {calls} device "
            f"calls ({n_attn} and {n_mrf} per call)")

        # (a) one zero-noise JP request against the engine's own float wave
        zero = dict(noise=0, noisew=0)
        text = TEXT_SENTENCES["JP"][0]
        pcm = wav_pcm(*http_json(url + "/voice", dict(
            text=text, model_id=0, speaker_name="spk2", language="JP", **zero)), sr)
        want = float_to_int16(engine.infer(text, "spk2", language="JP", noise_scale=0.0,
                                           noise_scale_w=0.0))
        lsb = (int(np.abs(pcm.astype(np.int32) - want.astype(np.int32)).max())
               if len(pcm) == len(want) else math.inf)
        log(f"[serve] (a) zero-noise JP /voice against float_to_int16(engine.infer): "
            f"{len(pcm)} / {len(want)} samples, max difference {lsb} LSB (bound 1)")
        if not lsb <= 1:
            raise AssertionError("[serve] (a) /voice and engine.infer disagree")

        # (b) a paragraph of four sentences in one bucket: one device call of 4
        sents = SERVE_PARAGRAPHS["EN"]
        keys = {engine.group_key(engine.prepare(t, 1, language="EN")) for t in sents}
        if len(keys) != 1:
            raise AssertionError(f"[serve] (b) the paragraph spans buckets {keys}")
        kw = dict(model_id=0, speaker="spk1", language="EN", noise=0.0, noisew=0.0)
        n0 = len(batcher.batch_sizes)
        para, _ = service.voice("\n".join(sents), auto_split=True, **kw)
        if batcher.batch_sizes[n0:] != [4]:
            raise AssertionError(f"[serve] (b) device calls {batcher.batch_sizes[n0:]}, "
                                 "want one of 4")
        alone = [service.voice(t, **kw)[0] for t in sents]
        gap = int(sr * 0.2)
        pieces, i = [], 0
        for w in alone:
            pieces.append(para[i:i + len(w)])
            i += len(w) + gap
        if i - gap != len(para):
            raise AssertionError(f"[serve] (b) paragraph of {len(para)} samples, pieces "
                                 f"{[len(w) for w in alone]}")
        err_b = max(float(np.abs(p - w).max()) for p, w in zip(pieces, alone))
        log(f"[serve] (b) auto_split paragraph of 4 (keys {keys}): one device call of 4; "
            f"each sentence against itself served alone: max_abs_err {err_b:.3e} "
            f"(bound {WAVE_BOUND:g})")
        if not err_b <= WAVE_BOUND:
            raise AssertionError("[serve] (b) a sentence depends on its batch company")

        # (c) the same request with batching off
        unbatched = TTSService(registry, batching=False)
        flat, _ = unbatched.voice("\n".join(sents), auto_split=True, **kw)
        err_c = (float(np.abs(flat - para).max()) if len(flat) == len(para) else math.inf)
        log(f"[serve] (c) batching off against on: {len(flat)} / {len(para)} samples, "
            f"max_abs_err {err_c:.3e} (bound {WAVE_BOUND:g})")
        if not err_c <= WAVE_BOUND:
            raise AssertionError("[serve] (c) batching off and on disagree")

        # (d) the card in /status, the engine's device in /models/info
        _, body = http_json(url + "/status")
        devices = json.loads(body)["Data"]["devices"]
        _, body = http_json(url + "/models/info")
        info = json.loads(body)
        log(f"[serve] (d) /status devices {devices}; /models/info device "
            f"{info['0']['device']}")
        if (not devices or devices[0]["kind"] != torch.cuda.get_device_name(0)
                or info["0"]["device"] != "cuda"):
            raise AssertionError("[serve] (d) /status or /models/info do not name the card")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    del engine, registry, service
    torch.cuda.empty_cache()
    return totals


def run_serve_cli(smi):
    """The server's entry point in a subprocess on a free port: its `serving
    on` line within CLI_TIMEOUT_S, one GET /status and two POST /voice (EN),
    each a WAV of a whole number of frames; then it is terminated."""
    root_dir = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        config, weights = write_engine_config(root)
        with open(config, encoding="utf-8") as f:
            data = json.load(f)["data"]
        hop, sr = data["hop_length"], data["sampling_rate"]
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cmd = [sys.executable, "-m", "bert_vits2_tpu_torch.serve.server", "--device", "cuda",
               "--host", "127.0.0.1", "--port", str(port), "--warmup",
               "--model", f"{weights}:{config}"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=root_dir, env=dict(os.environ, PYTHONUNBUFFERED="1"),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines: queue.Queue = queue.Queue()

        def read():
            for x in proc.stdout:
                lines.put(x)

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        out = []
        try:
            while not any(x.startswith("serving on") for x in out):
                left = CLI_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    out.append(lines.get(timeout=max(left, 0.1)).rstrip())
                except queue.Empty:
                    raise AssertionError(f"[serve-cli] no `serving on` line in "
                                         f"{CLI_TIMEOUT_S} s: {out[-20:]}") from None
                if proc.poll() is not None and lines.empty():
                    raise AssertionError(f"[serve-cli] the server exited with "
                                         f"{proc.returncode}: {out[-20:]}")
            up_s = time.perf_counter() - t0
            for x in out:
                if x.startswith(("model ", "serving on")):
                    log(f"[serve-cli] {x}")
            url = f"http://127.0.0.1:{port}"
            _, body = http_json(url + "/status")
            devices = json.loads(body)["Data"]["devices"]
            voice_ms = []
            for _ in range(2):  # the first request also loads the EN g2p's lexicon
                t = time.perf_counter()
                ctype, body = http_json(url + "/voice", dict(
                    text=TEXT_SENTENCES["EN"][2], speaker_name="spk3", language="EN"))
                voice_ms.append((time.perf_counter() - t) * 1e3)
                pcm = wav_pcm(ctype, body, sr)
                cap = 6 * 128 * hop  # the 128-token bucket's worst-case frame cap
                if len(pcm) % hop or not hop <= len(pcm) <= cap:
                    raise AssertionError(f"[serve-cli] a WAV of {len(pcm)} samples: not a "
                                         f"whole number of {hop}-sample frames up to {cap}")
            if not devices or devices[0]["kind"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"[serve-cli] /status devices {devices}")
            log(f"[serve-cli] {smi}: `serving on` after {up_s:.1f} s (interpreter, load, "
                f"warmup); /status lists {devices[0]['kind']}; POST /voice (EN) twice in "
                f"{voice_ms[0]:.1f} and {voice_ms[1]:.1f} ms: a RIFF WAV of {len(pcm)} "
                f"samples ({len(pcm) // hop} frames)")
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            reader.join(10)


BERT_CONFIGS = {  # published widths of the reference's two BERT families
    "chinese-roberta-wwm-ext-large": dict(
        vocab_size=21128, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=512, type_vocab_size=2,
        layer_norm_eps=1e-12),
    "deberta-v3-large": dict(
        vocab_size=128100, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=512, type_vocab_size=0,
        layer_norm_eps=1e-7, position_biased_input=False, relative_attention=True,
        position_buckets=256, pos_att_type=("p2c", "c2p"), share_att_key=True,
        norm_rel_ebd="layer_norm"),
}
BERT_T = 64
BERT_BOUND = 1e-3  # card vs CPU, fp32, TF32 off: 22 layers of 1024/4096-term sums to the tap


def bert_flops(cfg, t: int) -> float:
    """The encoder's fp32 products for one sequence of t ids: projections,
    FFN, scores and context, and (DeBERTa) the position projections of the
    2s relative rows and the c2p/p2c scores."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_layer = 2 * t * (4 * h * h + 2 * h * i) + 2 * 2 * t * t * h
    if cfg.relative_attention:
        rows = 2 * cfg.pos_ebd_size
        per_layer += 2 * 2 * rows * h * h + 2 * 2 * t * rows * h
    return cfg.num_layers * per_layer


def bert_bytes(model, t: int) -> float:
    """Every parameter read once, except the embedding tables, of which the
    t rows looked up."""
    emb = [m.weight for m in model.modules() if isinstance(m, torch.nn.Embedding)]
    n = sum(p.numel() for p in model.parameters()) - sum(w.numel() for w in emb)
    return 4.0 * (n + t * sum(w.shape[1] for w in emb))


def run_bert(smi):
    """The BERT encoder (text/bert_encoder.py) at two published widths, random
    weights from a seed, t = BERT_T ids from a seed: ms per forward (CUDA
    events), peak memory, and hidden_states[-3] card against CPU."""
    from bert_vits2_tpu_torch.text.bert_encoder import BertEncoder, EncoderConfig

    for i, (name, kw) in enumerate(BERT_CONFIGS.items()):
        cfg = EncoderConfig(**kw)
        torch.manual_seed(i)
        cpu_model = BertEncoder(cfg).eval()
        model = copy.deepcopy(cpu_model).to("cuda")
        ids = torch.from_numpy(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (1, BERT_T)))
        mask = torch.ones_like(ids)
        n_params = sum(p.numel() for p in model.parameters())
        with torch.inference_mode():
            ids_d, mask_d = ids.cuda(), mask.cuda()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: model(ids_d, mask_d), iters=10, warmup=3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            dev = device_ms(lambda: model(ids_d, mask_d))
            got = model(ids_d, mask_d)[-3].cpu()
            t0 = time.perf_counter()
            want = cpu_model(ids, mask)[-3]
            cpu_s = time.perf_counter() - t0
        err = float((got - want).abs().max())
        bound_ms, bound_by = bound(bert_flops(cfg, BERT_T), bert_bytes(model, BERT_T))
        log(f"[bert] {smi}: {name} ({n_params} parameters, {cfg.num_layers} layers, "
            f"hidden {cfg.hidden_size}), t = {BERT_T}: {ms:.3f} ms per forward "
            f"(CUDA events, 10 after 3 warm-up, fp32 TF32 off), device {dev:.3f} ms "
            f"(the profiler's kernel time), bound {bound_ms:.3f} ms ({bound_by}: every "
            f"weight read once, fp32 products at 67 TFLOP/s), peak memory {peak:.2f} "
            f"GiB; hidden_states[-3] card vs CPU max_abs_err {err:.3e} (bound "
            f"{BERT_BOUND:g}, |max| {float(want.abs().max()):.3f}); CPU forward "
            f"{cpu_s:.2f} s")
        if not (torch.isfinite(got).all() and err <= BERT_BOUND):
            raise AssertionError(f"[bert] {name}: card and CPU disagree")
        del model, cpu_model
        torch.cuda.empty_cache()


def run_trainer(dev, smi, counters):
    """The training entry point (the `python -m bert_vits2_tpu_torch.train`
    CLI's Trainer) on a synthetic corpus at the default V2.3 width, the
    attention on K1-train/B5/B6 (BV2_FUSED_ATTENTION_TRAIN=1), no SLM: the
    kernels' launches per step, finite metrics, moved parameters, a
    checkpoint, a resumed second Trainer; step time, peak memory and a
    profile of one step."""
    from torch.profiler import ProfilerActivity, profile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    from bert_vits2_tpu_torch.train.__main__ import main as train_main
    from bert_vits2_tpu_torch.train.trainer import Trainer

    n_steps = TRAINER_WARMUP + TRAINER_TIMED
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            cfg_path = write_corpus(root, TRAINER_UTTS)
            model_dir = os.path.join(root, "model")
            trainer = Trainer(cfg_path, model_dir, slm_path=None, device="cuda")
            if trainer.mcfg != ModelConfig():
                raise AssertionError("the corpus config is not the default V2.3 width")
            n_attn = sum(isinstance(m, MultiHeadAttention)
                         for m in trainer.models.synthesizer.modules())
            cfg = trainer.mcfg
            if n_attn != cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow:
                raise AssertionError(f"{n_attn} attention layers in the model")
            log(f"[trainer] corpus of {TRAINER_UTTS} utterances and the Trainer "
                f"built in {time.perf_counter() - t0:.1f} s; {len(trainer.sampler)} "
                f"batches of {TRAIN_BATCH} per epoch; {n_attn} attention layers")
            before = [[p.detach().clone() for p in m.parameters()]
                      for m in trainer.models[:3]]
            step_fn, record = trainer.step_fn, {"times": [], "shapes": set()}

            def timed_step(state, batch, generator, lr):
                i = len(record["times"])
                if i == TRAINER_WARMUP:
                    torch.cuda.reset_peak_memory_stats()
                record["shapes"].add((tuple(batch["x"].shape),
                                      tuple(batch["spec"].shape)))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == n_steps - 1:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        out = step_fn(state, batch, generator, lr)
                        torch.cuda.synchronize()
                    record["prof"] = (prof, time.perf_counter() - t0)
                else:
                    out = step_fn(state, batch, generator, lr)
                    torch.cuda.synchronize()
                record["times"].append(time.perf_counter() - t0)
                record["metrics"] = out[1]
                return out

            trainer.step_fn = timed_step
            for fn in counters.values():
                fn.launches = 0
            trainer.run(max_steps=n_steps, keep_ckpts=2)
            launches = {k: fn.launches for k, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            metrics = trainer._assert_finite(record["metrics"])
            log(f"[trainer] step {trainer.global_step}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in sorted(metrics.items())))
            want = {k: 0 for k in counters}
            want.update({k: n_attn * n_steps for k in (
                "banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k")})
            want["mas_fwd"] = n_steps
            log(f"[trainer] kernel launches over {n_steps} steps {launches} "
                f"(expected {want}); batch shapes (x, spec) {sorted(record['shapes'])}")
            if launches != want:
                raise AssertionError(f"Trainer kernel launches {launches}")
            for name, module, old in zip(("G", "D", "duration D"),
                                         trainer.models[:3], before):
                moved = sum(not torch.equal(p.detach(), o)
                            for p, o in zip(module.parameters(), old))
                log(f"[trainer] {name}: {moved} of {len(old)} parameter tensors changed")
                if moved < 0.9 * len(old):
                    raise AssertionError(f"{name} parameters did not move")
            del before
            saved = sorted(os.listdir(trainer.ckpt_dir))
            if saved != [f"DUR_{n_steps}.pth", f"D_{n_steps}.pth", f"G_{n_steps}.pth"]:
                raise AssertionError(f"checkpoints {saved}")
            timed = record["times"][TRAINER_WARMUP:-1]
            med = float(np.median(timed))
            log(f"[trainer-timing] {smi}: {len(timed)} steps after "
                f"{TRAINER_WARMUP} warm-up (each closed by a synchronize): median "
                f"{med * 1e3:.1f} ms, max {max(timed) * 1e3:.1f} ms per step; "
                f"{1 / med:.3f} steps/s; peak memory {peak:.2f} GiB")
            prof, wall = record["prof"]
            profile_lines(prof, wall, "one Trainer step, fused attention", top=16)
            t0 = time.perf_counter()
            trainer.evaluate(max_items=1, max_frames=768)
            log(f"[trainer] evaluate (Synthesizer.infer, SDP and DP) in "
                f"{time.perf_counter() - t0:.1f} s")
            del trainer
            torch.cuda.empty_cache()

            # the CLI on the same directory resumes at the saved step
            resumed = train_main(["-c", cfg_path, "-m", model_dir, "--no-slm",
                                  "--max-steps", str(n_steps + 1),
                                  "--keep-ckpts", "1"])
            if resumed.global_step != n_steps + 1:
                raise AssertionError(f"the CLI stopped at {resumed.global_step}")
            saved = sorted(os.listdir(resumed.ckpt_dir))
            log(f"[trainer] the CLI resumed at step {n_steps} and ran to "
                f"{resumed.global_step}; checkpoints kept {saved}")
            if saved != [f"DUR_{n_steps + 1}.pth", f"D_{n_steps + 1}.pth",
                         f"G_{n_steps + 1}.pth"]:
                raise AssertionError(f"checkpoints {saved}")
            del resumed
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    return launches


def make_wavlm(seed):
    """A WavLM at the published microsoft/wavlm-base-plus widths, random
    weights drawn from a seed (torch's default initializers)."""
    from bert_vits2_tpu_torch.models.slm import WavLM, WavLMConfig
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return WavLM(WavLMConfig()).eval()


def slm_pieces(slm, wd, y, y_hat):
    """The SLM terms of the training step (train/step.py, 2c and 3) on one
    real and one fake wave: (hidden states of y, loss_wd, lm, lm_gen, the
    WavLM discriminator's gradient, d(lm + lm_gen)/d y_hat)."""
    y_hat = y_hat.detach().requires_grad_(True)
    with torch.no_grad():
        hs_real = slm(y)
    hs_fake = slm(y_hat)
    emb_fake = slm.embed(hs_fake)
    wd.zero_grad(set_to_none=True)
    loss_wd = (torch.mean((1.0 - wd(slm.embed(hs_real))) ** 2)
               + torch.mean(wd(emb_fake.detach()) ** 2))
    loss_wd.backward()
    grads = {n: p.grad.detach().clone() for n, p in wd.named_parameters()}
    for p in wd.parameters():
        p.requires_grad_(False)
    try:
        lm = sum(torch.mean(torch.abs(r - f)) for r, f in zip(hs_real, hs_fake))
        lm_gen = torch.mean((1.0 - wd(emb_fake)) ** 2)
        (lm + lm_gen).backward()
    finally:
        for p in wd.parameters():
            p.requires_grad_(True)
    return (hs_real, loss_wd.detach(), lm.detach(), lm_gen.detach(), grads,
            y_hat.grad)


def check_slm_on_cpu(slm, wd, cfg, data_cfg, dev, strict=True):
    """The SLM pieces, card against CPU, from the same weights at a small
    batch: their errors, and lm_gen's value on the CPU. With `strict`, raises
    with every error when one passes its bound."""
    from bert_vits2_tpu_torch.models.discriminators import WavLMDiscriminator
    from bert_vits2_tpu_torch.models.slm import SLM, WavLM

    rng = np.random.default_rng(11)
    seg = cfg.segment_samples
    y, y_hat = (torch.from_numpy(rng.uniform(-0.5, 0.5, (SLM_CHECK_BATCH, seg))
                                 .astype(np.float32)) for _ in range(2))
    cpu_wavlm = WavLM(slm.wavlm.cfg)
    cpu_wavlm.load_state_dict({k: v.cpu() for k, v in slm.wavlm.state_dict().items()})
    cpu_slm = SLM(cpu_wavlm, data_cfg.sampling_rate, cfg.slm_sr)
    cpu_wd = WavLMDiscriminator(cfg.slm_hidden, cfg.slm_layers,
                                cfg.slm_initial_channel)
    cpu_wd.load_state_dict({k: v.cpu() for k, v in wd.state_dict().items()})
    t0 = time.perf_counter()
    want = slm_pieces(cpu_slm, cpu_wd, y, y_hat)
    cpu_s = time.perf_counter() - t0
    got = slm_pieces(slm, wd, y.to(dev), y_hat.to(dev))
    hs_err = max((g.cpu() - w).abs().max().item() for g, w in zip(got[0], want[0]))
    names = ("loss/wd/total", "loss/g/lm", "loss/g/lm_gen")
    loss_abs = {k: abs(float(g) - float(w)) for k, g, w in zip(names, got[1:4], want[1:4])}
    loss_err = {k: loss_abs[k] / abs(float(w)) for k, w in zip(names, want[1:4])}
    grad_abs = {n: (got[4][n].cpu() - w).abs().max().item() for n, w in want[4].items()}
    grad_err = max(grad_abs[n] / w.norm().item() for n, w in want[4].items())
    wave_abs = (got[5].cpu() - want[5]).abs().max().item()
    wave_err = wave_abs / want[5].norm().item()
    log(f"[train-slm] card vs CPU, batch {SLM_CHECK_BATCH} of {seg} samples at "
        f"44.1 kHz, the same weights: WavLM hidden states ({len(want[0])} of "
        f"{list(want[0][0].shape)}) max_abs_err {hs_err:.3e} (bound {WAVLM_BOUND:g}); "
        "losses max_abs_err / relative " + ", ".join(
            f"{k} {loss_abs[k]:.3e} / {loss_err[k]:.3e}" for k in names)
        + f"; WavLM discriminator gradient max_abs_err {max(grad_abs.values()):.3e}, "
        f"max error / norm {grad_err:.3e}; d(lm + lm_gen)/d y_hat max_abs_err "
        f"{wave_abs:.3e}, / norm {wave_err:.3e} (relative bound {SLM_REL_BOUND:g}); "
        f"CPU run {cpu_s:.1f} s")
    errs = {"hidden_states": hs_err, **loss_err, "wd_grad": grad_err,
            "wave_grad": wave_err, "lm_gen": float(want[3])}
    if strict and not (hs_err <= WAVLM_BOUND and max(loss_err.values()) <= SLM_REL_BOUND
                       and grad_err <= SLM_REL_BOUND and wave_err <= SLM_REL_BOUND):
        raise AssertionError(f"card and CPU disagree on the SLM losses: {errs}")
    return errs


def run_slm_drift(dev, smi, n_steps):
    """`--slm-drift N`: the [train-slm] card-vs-CPU check on the seeded
    discriminator, then after each of N SLM steps on one batch, reported
    and not held to the bounds: how lm_gen's value on the check's noise and
    the relative errors move as the discriminator trains."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.slm import SLM
    from bert_vits2_tpu_torch.train import (
        DataConfig, TrainConfig, init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    cfg, data_cfg, train_cfg = ModelConfig(), DataConfig(), TrainConfig()
    wavlm = make_wavlm(seed=5)
    slm = SLM(wavlm, data_cfg.sampling_rate, cfg.slm_sr).to(dev)
    models = init_params(build_models(cfg, use_wavlm_disc=True, device="cuda",
                                      wavlm=wavlm.cfg), cfg, seed=1234)
    step = make_train_step(models, train_cfg, data_cfg, cfg.segment_size, slm=slm)
    state = init_train_state(models, train_cfg)
    batch = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX,
                             TRAIN_TY, seed=0, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    rows = [check_slm_on_cpu(slm, models.wavlm_disc, cfg, data_cfg, dev, strict=False)]
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        for _ in range(n_steps):
            state, _ = step(state, batch, gen, train_cfg.learning_rate)
            rows.append(check_slm_on_cpu(slm, models.wavlm_disc, cfg, data_cfg,
                                         dev, strict=False))
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    rel = [max(r["loss/wd/total"], r["loss/g/lm"], r["loss/g/lm_gen"], r["wd_grad"],
               r["wave_grad"]) for r in rows]
    lm_gen = ", ".join(f"{r['lm_gen']:.4g}" for r in rows)
    log(f"[slm-drift] {smi}: lm_gen on the check's noise before the steps and after "
        f"each of {n_steps}: [{lm_gen}]; the largest relative error of each check: "
        f"[{', '.join(f'{e:.3g}' for e in rel)}] (bound {SLM_REL_BOUND:g}); over the "
        f"bound in {sum(e > SLM_REL_BOUND for e in rel)} of {len(rel)}")
    return rows


def run_training_slm(dev, smi, counters):
    """Phase 7b: the GAN step with the SLM losses at the default V2.3 config,
    full width, fp32, fused attention, against the same step without them,
    in turns, on one batch and one set of modules."""
    from torch.profiler import ProfilerActivity, profile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models.slm import SLM
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    from bert_vits2_tpu_torch.train import (
        DataConfig, TrainConfig, init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    cfg, data_cfg, train_cfg = ModelConfig(), DataConfig(), TrainConfig()
    t0 = time.perf_counter()
    wavlm = make_wavlm(seed=5)
    slm = SLM(wavlm, data_cfg.sampling_rate, cfg.slm_sr).to(dev)
    models = init_params(build_models(cfg, use_wavlm_disc=True, device="cuda",
                                      wavlm=wavlm.cfg), cfg, seed=1234)
    plain = models._replace(wavlm_disc=None)
    steps = {"slm": make_train_step(models, train_cfg, data_cfg, cfg.segment_size,
                                    slm=slm),
             "plain": make_train_step(plain, train_cfg, data_cfg, cfg.segment_size)}
    states = {"slm": init_train_state(models, train_cfg),
              "plain": init_train_state(plain, train_cfg)}
    batch = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX,
                             TRAIN_TY, seed=0, dev=dev)
    n_attn = sum(isinstance(m, MultiHeadAttention)
                 for m in models.synthesizer.modules())
    n_wavlm = sum(p.numel() for p in wavlm.parameters())
    n_wd = sum(p.numel() for p in models.wavlm_disc.parameters())
    log(f"[train-slm] default V2.3 config, fp32, TF32 off, fused attention: a "
        f"random WavLM at the wavlm-base-plus widths ({wavlm.cfg.num_layers} layers "
        f"of {wavlm.cfg.hidden_size}, {n_wavlm} parameters, frozen) and a "
        f"WavLMDiscriminator({cfg.slm_hidden}, {cfg.slm_layers}, "
        f"{cfg.slm_initial_channel}) of {n_wd} parameters; batch {TRAIN_BATCH}; "
        f"built in {time.perf_counter() - t0:.1f} s")
    # card against CPU on the seeded weights, before the steps: the steps
    # train the discriminator towards D = 1 on the check's noise, so lm_gen
    # falls towards 0 there and its relative error grows with each step
    check_slm_on_cpu(slm, models.wavlm_disc, cfg, data_cfg, dev)
    models.wavlm_disc.zero_grad(set_to_none=True)
    wd_before = [p.detach().clone() for p in models.wavlm_disc.parameters()]
    wavlm_before = [p.detach().clone() for p in wavlm.parameters()]
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    fused = ("banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k",
             "mas_fwd")
    want = {k: n_attn for k in fused[:3]}
    want["mas_fwd"] = 1
    times, peaks = {"slm": [], "plain": []}, {"slm": 0.0, "plain": 0.0}
    per_step, metrics = {}, None
    order = ["slm", "plain"] + ["slm", "plain", "plain", "slm"] * SLM_ROUNDS
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        for i, mode in enumerate(order):  # the first two steps warm up
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[mode], out = steps[mode](states[mode], batch, gen,
                                            train_cfg.learning_rate)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {k: counters[k].launches for k in counters}
            if {k: got[k] for k in fused} != want or sum(got.values()) != sum(want.values()):
                raise AssertionError(f"a {mode} step launched {got}, not {want}")
            bad = {k: float(v) for k, v in out.items() if not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f"non-finite metrics in a {mode} step: {bad}")
            if mode == "slm":
                per_step, metrics = got, out
            if i >= 2:
                times[mode].append(sec)
                peaks[mode] = max(peaks[mode], torch.cuda.max_memory_allocated() / 2**30)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            states["slm"], _ = steps["slm"](states["slm"], batch, gen,
                                            train_cfg.learning_rate)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_lines(prof, wall, "one training step with the SLM losses", top=12)
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    names = ("loss/wd/total", "grad_norm_wd", "loss/g/lm", "loss/g/lm_gen")
    if any(k not in metrics for k in names):
        raise AssertionError(f"SLM metrics missing: {sorted(metrics)}")
    log("[train-slm] last SLM step: " + ", ".join(
        f"{k} {float(metrics[k]):.4g}" for k in names + ("loss/g/total",)))
    moved = sum(not torch.equal(p.detach(), o)
                for p, o in zip(models.wavlm_disc.parameters(), wd_before))
    still = all(torch.equal(p, o) for p, o in zip(wavlm.parameters(), wavlm_before))
    log(f"[train-slm] WavLM discriminator: {moved} of {len(wd_before)} parameter "
        f"tensors changed; the frozen WavLM unchanged {still}, its parameters "
        f"without gradients {all(p.grad is None for p in wavlm.parameters())}")
    if moved < len(wd_before) or not still:
        raise AssertionError("the WavLM discriminator did not move or the WavLM did")
    del wd_before, wavlm_before
    log(f"[train-slm] launches per SLM step {{K1-train/B5/B6: "
        f"{[per_step[k] for k in fused[:3]]}, K3: {per_step['mas_fwd']}}} "
        f"(expected {n_attn} each and 1, as without the SLM)")
    med = {k: float(np.median(v)) for k, v in times.items()}
    log(f"[train-slm-timing] {smi}: {len(times['slm'])} steps each in turns "
        f"(S N N S) after one warm-up each: with the SLM median "
        f"{med['slm'] * 1e3:.1f} ms (max {max(times['slm']) * 1e3:.1f}), peak "
        f"{peaks['slm']:.2f} GiB; without median {med['plain'] * 1e3:.1f} ms (max "
        f"{max(times['plain']) * 1e3:.1f}), peak {peaks['plain']:.2f} GiB; "
        f"slm/plain {med['slm'] / med['plain']:.3f}")
    wave = batch["wave"][:, :cfg.segment_samples].contiguous()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: slm(wave), iters=10)
        frames = slm(wave)[0].shape[1]
    log(f"[train-slm-timing] {smi}: SLM forward (resampler and WavLM, no grad) "
        f"at [{TRAIN_BATCH}, {cfg.segment_samples}] samples at 44.1 kHz -> "
        f"{frames} frames: {fwd_ms:.3f} ms (CUDA events, 10 calls)")
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slm(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_lines(prof, wall, "one SLM forward", top=8)
    del models, plain, states, steps, slm, wavlm
    torch.cuda.empty_cache()
    return per_step


def write_wavlm(path, seed):
    """A random WavLM at the published widths as an HF checkpoint
    directory: config.json in HF keys and pytorch_model.bin."""
    wavlm = make_wavlm(seed)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(wavlm.cfg.to_hf(), f)
    torch.save(wavlm.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return wavlm


def run_trainer_slm(dev, smi, counters):
    """Phase 9b: the Trainer with the SLM losses, as config.json declares
    them: model.slm.model names a WavLM directory that the phase writes
    (random weights, published widths), and the default slm_path="auto"
    loads it. A few steps (K1-train/B5/B6 and K3 launches per step, finite
    SLM metrics), WD_*.pth beside G_/D_/DUR_*.pth, and a second Trainer
    that resumes from them."""
    from bert_vits2_tpu_torch.models.discriminators import WavLMDiscriminator
    from bert_vits2_tpu_torch.train.trainer import Trainer

    n_steps = TRAINER_SLM_WARMUP + TRAINER_SLM_TIMED
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            wl_dir = os.path.join(root, "wavlm-base-plus")
            written = write_wavlm(wl_dir, seed=6)
            cfg_path = write_corpus(root, TRAINER_UTTS, slm_dir=wl_dir)
            model_dir = os.path.join(root, "model")
            trainer = Trainer(cfg_path, model_dir, device="cuda")
            if trainer.slm is None or not isinstance(trainer.models.wavlm_disc,
                                                     WavLMDiscriminator):
                raise AssertionError("the Trainer did not turn the SLM losses on")
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                trainer.slm.wavlm.state_dict().values(), written.state_dict().values()))
            log(f"[trainer-slm] a random WavLM written to {os.path.basename(wl_dir)}/ "
                f"(config.json, pytorch_model.bin of "
                f"{os.path.getsize(os.path.join(wl_dir, 'pytorch_model.bin')) / 2**20:.0f} "
                f"MiB) and loaded by Trainer(slm_path='auto') equal to the written "
                f"weights {same}; corpus and Trainer built in "
                f"{time.perf_counter() - t0:.1f} s")
            if not same:
                raise AssertionError("the loaded WavLM differs from the written one")
            step_fn, record = trainer.step_fn, {"times": [], "launches": []}

            def counted_step(state, batch, generator, lr):
                for fn in counters.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(state, batch, generator, lr)
                torch.cuda.synchronize()
                record["times"].append(time.perf_counter() - t0)
                record["launches"].append({k: fn.launches for k, fn in counters.items()})
                record["metrics"] = out[1]
                return out

            trainer.step_fn = counted_step
            trainer.run(max_steps=n_steps, keep_ckpts=2)
            metrics = trainer._assert_finite(record["metrics"])
            log(f"[trainer-slm] step {trainer.global_step}: " + ", ".join(
                f"{k} {metrics[k]:.4g}" for k in ("loss/wd/total", "grad_norm_wd",
                                                  "loss/g/lm", "loss/g/lm_gen",
                                                  "loss/g/total")))
            n_attn = trainer.mcfg.n_layers + (trainer.mcfg.n_flow_layer
                                              * trainer.mcfg.n_layers_trans_flow)
            want = {k: 0 for k in counters}
            want.update({k: n_attn for k in TC_KEYS}, mas_fwd=1)
            if any(got != want for got in record["launches"]):
                raise AssertionError(f"Trainer SLM step launches {record['launches']}")
            saved = sorted(os.listdir(trainer.ckpt_dir))
            expect = [f"{p}_{n_steps}.pth" for p in ("DUR", "D", "G", "WD")]
            timed = record["times"][TRAINER_SLM_WARMUP:]
            wd_mib = os.path.getsize(os.path.join(trainer.ckpt_dir,
                                                  f"WD_{n_steps}.pth")) / 2**20
            log(f"[trainer-slm] launches per step K1-train/B5/B6 {n_attn}, K3 1 in "
                f"each of {n_steps} steps; checkpoints {saved} (WD_{n_steps}.pth "
                f"{wd_mib:.1f} MiB)")
            log(f"[trainer-slm-timing] {smi}: {len(timed)} steps after "
                f"{TRAINER_SLM_WARMUP} warm-up: median {np.median(timed) * 1e3:.1f} ms, "
                f"max {max(timed) * 1e3:.1f} ms per step")
            if saved != expect:
                raise AssertionError(f"checkpoints {saved}, not {expect}")
            wd_saved = {k: v.detach().cpu().clone()
                        for k, v in trainer.models.wavlm_disc.state_dict().items()}
            del trainer
            torch.cuda.empty_cache()

            resumed = Trainer(cfg_path, model_dir, device="cuda")
            if resumed.global_step != n_steps or not all(
                    torch.equal(v.cpu(), wd_saved[k]) for k, v in
                    resumed.models.wavlm_disc.state_dict().items()):
                raise AssertionError("the second Trainer did not resume the WavLM "
                                     "discriminator")
            resumed.run(max_steps=n_steps + 1, keep_ckpts=1)
            saved = sorted(os.listdir(resumed.ckpt_dir))
            log(f"[trainer-slm] a second Trainer resumed at step {n_steps} (the "
                f"WavLM discriminator as saved) and ran to {resumed.global_step}; "
                f"checkpoints kept {saved}")
            if saved != [f"{p}_{n_steps + 1}.pth" for p in ("DUR", "D", "G", "WD")]:
                raise AssertionError(f"checkpoints {saved}")
            del resumed
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)


def check_training_forward_on_cpu(dev):
    """Phase 8: the training forward at full width and a cut depth, eval()
    mode, on the card and on the CPU with the same noise (a CPU generator
    with one seed feeds both)."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models import build_synthesizer
    from bert_vits2_tpu_torch.train import DataConfig

    cfg = ModelConfig(n_layers=3, n_flow_layer=2, n_layers_trans_flow=3)
    cpu_model = build_synthesizer(cfg, device="cpu", seed=2)
    nonzero_init(cpu_model)
    gpu_model = build_synthesizer(cfg, device="cuda", state_dict=cpu_model.state_dict())
    batch = make_train_batch(cfg, DataConfig().hop_length, 2, 24, 96, seed=1,
                             dev="cpu")
    keys = ("x", "x_lengths", "spec", "spec_lengths", "sid", "tone", "language",
            "bert", "ja_bert", "en_bert")
    outs = []
    for model, where in ((cpu_model, "cpu"), (gpu_model, dev)):
        with torch.no_grad():
            out = model(*(batch[k].to(where) for k in keys), mas_noise_scale=0.01,
                        generator=torch.Generator().manual_seed(5))
        outs.append({k: v.cpu() for k, v in out.items()})
    cpu, gpu = outs
    same = torch.equal(cpu["attn"], gpu["attn"]) and torch.equal(
        cpu["ids_slice"], gpu["ids_slice"])
    len_err = ((cpu["l_length"] - gpu["l_length"]).abs()
               / cpu["l_length"].abs()).max().item()
    wave_err = (cpu["wave_slice"] - gpu["wave_slice"]).abs().max().item()
    log(f"[cpu] training forward, 3 encoder layers and 2 flow couplings of 3, "
        f"eval(), same noise: attn and slice starts equal {same}; l_length "
        f"{gpu['l_length'].tolist()} max relative error {len_err:.3e} (bound "
        f"{LENGTH_REL_BOUND:g}); wave_slice max_abs_err {wave_err:.3e} (bound "
        f"{WAVE_BOUND:g})")
    if not (same and len_err <= LENGTH_REL_BOUND and wave_err <= WAVE_BOUND):
        if not same:
            first = (cpu["attn"] != gpu["attn"]).nonzero()[:1].tolist()
            log(f"[cpu] attn differs first at [b, y, x] = {first}")
        raise AssertionError("card and CPU disagree on the training forward")


def check_attention_module_bf16(dev, counters):
    """A bf16 MultiHeadAttention outside the tensor-core range (d = 160) in
    fused training (BV2_FUSED_ATTENTION_TRAIN=1, the hash dropout from one
    seed) on the card and on the CPU, float32 parameters: the output within
    BF16_CPU_REL of its largest entry, the parameter gradients within it of
    the largest gradient entry; the wide kernels' bf16 modes launched once
    each, no other kernel. Returns the launches."""
    from bert_vits2_tpu_torch.nn.attention import MultiHeadAttention
    channels, heads, window = RANGE_MODULES[0]
    t, lens = RANGE_T, RANGE_LENS
    torch.manual_seed(channels)
    cpu = MultiHeadAttention(channels, channels, heads, window_size=window,
                             p_dropout=0.1).train()
    gpu = copy.deepcopy(cpu).to(dev)
    x = torch.randn(len(lens), channels, t).to(torch.bfloat16)
    r = torch.randn(len(lens), channels, t)
    m = lens_mask(lens, t, "cpu")[:, None, :]
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    outs, grads = [], []
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        for mod, where in ((cpu, "cpu"), (gpu, dev)):
            torch.manual_seed(7)  # the hash dropout's seed
            out = mod(x.to(where), m.to(where)).float() * m.to(where)
            (out * r.to(where)).sum().backward()
            outs.append(out.detach().cpu())
            grads.append([p.grad.cpu() for p in mod.parameters()])
        torch.cuda.synchronize()
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    launches = {k: fn.launches for k, fn in counters.items()}
    e_out = ((outs[0] - outs[1]).abs().max() / outs[0].abs().max()).item()
    scale = max(g.abs().max().item() for g in grads[0])
    e_grad = max((g1 - g0).abs().max().item() for g0, g1 in zip(*grads)) / scale
    dtypes = {str(p.dtype) for p in gpu.parameters()} | {str(g.dtype) for g in grads[1]}
    log(f"[train-bf16] MultiHeadAttention({channels}, {heads} head, window {window}) "
        f"in fused training on bf16 activations, float32 parameters and gradients "
        f"({sorted(dtypes)}), [b={len(lens)}, t={t}]: card vs CPU output "
        f"{e_out:.2e} of its largest entry, parameter gradients {e_grad:.2e} of the "
        f"largest (bound {BF16_CPU_REL:g}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    want = {k: 0 for k in counters}
    want.update({k: 1 for k in WIDE_BF16_KEYS})
    if launches != want or dtypes != {"torch.float32"}:
        raise AssertionError(f"[train-bf16] the bf16 module: launches {launches}, "
                             f"dtypes {dtypes}")
    if not (e_out <= BF16_CPU_REL and e_grad <= BF16_CPU_REL):
        raise AssertionError("[train-bf16] the bf16 module: card and CPU disagree")
    return {k: launches[k] for k in WIDE_BF16_KEYS}


def check_training_forward_bf16_on_cpu(dev):
    """The bf16 training forward (train_compute_dtype "bfloat16") at full
    width and a cut depth, eval(), zero MAS noise, the same posterior noise
    (one CPU generator seed), on the card and on the CPU: z_p, m_q, logs_q
    and wave_slice (which do not depend on the alignment) within
    BF16_CPU_REL of each one's largest entry; the alignments' agreement
    and l_length reported."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.models import build_synthesizer
    from bert_vits2_tpu_torch.train import DataConfig

    cfg = ModelConfig(n_layers=3, n_flow_layer=2, n_layers_trans_flow=3,
                      train_compute_dtype="bfloat16")
    cpu_model = build_synthesizer(cfg, device="cpu", seed=2)
    nonzero_init(cpu_model)
    gpu_model = build_synthesizer(cfg, device="cuda", state_dict=cpu_model.state_dict())
    batch = make_train_batch(cfg, DataConfig().hop_length, 2, 24, 96, seed=1,
                             dev="cpu")
    keys = ("x", "x_lengths", "spec", "spec_lengths", "sid", "tone", "language",
            "bert", "ja_bert", "en_bert")
    outs = []
    for model, where in ((cpu_model, "cpu"), (gpu_model, dev)):
        with torch.no_grad():
            out = model(*(batch[k].to(where) for k in keys), mas_noise_scale=0.0,
                        generator=torch.Generator().manual_seed(5))
        outs.append({k: v.cpu() for k, v in out.items()})
    cpu, gpu = outs
    errs = {k: ((cpu[k].float() - gpu[k].float()).abs().max()
                / cpu[k].float().abs().max()).item()
            for k in ("z", "z_p", "m_q", "logs_q", "wave_slice")}
    valid = cpu["y_mask"][:, 0].bool()
    agree = (cpu["attn"].argmax(2) == gpu["attn"].argmax(2))[valid].float().mean().item()
    dtypes = {k: str(gpu[k].dtype)[6:] for k in ("z", "z_p", "m_q", "wave_slice")}
    log(f"[train-bf16] training forward in bf16, 3 encoder layers and 2 flow "
        f"couplings of 3, eval(), zero MAS noise: card vs CPU, each relative to its "
        f"largest entry: " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (bound {BF16_CPU_REL:g}); dtypes {dtypes}; alignment equal on "
        f"{100 * agree:.1f}% of valid frames; l_length card "
        f"{gpu['l_length'].tolist()} cpu {cpu['l_length'].tolist()}")
    if dtypes != {"z": "bfloat16", "z_p": "float32", "m_q": "float32",
                  "wave_slice": "float32"}:
        raise AssertionError(f"[train-bf16] forward output dtypes {dtypes}")
    if not (all(e <= BF16_CPU_REL for e in errs.values())
            and torch.equal(cpu["ids_slice"], gpu["ids_slice"])):
        raise AssertionError("card and CPU disagree on the bf16 training forward")


def run_training_bf16(dev, smi, counters):
    """[train-bf16]: the bf16 kernels of the training direction against
    their plain versions, the bf16 module outside the tensor-core range,
    then the default V2.3 models at init_params(seed=1234) twice, one with
    train_compute_dtype "bfloat16" and TrainConfig(bf16_run=True), on the
    [train] batch with fused attention: the first step of each from the
    same weights, noise and dropout seeds (losses within BF16_LOSS_REL,
    finite grad norms, float32 master parameters, the kernels' launches),
    then steps in turns (F B B F), peak memory, a profile of one step each.
    Returns (kernel rows by name, launches by name)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.train import (
        DataConfig, TrainConfig, init_train_state, make_train_step)
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    t0 = time.perf_counter()
    design = lambda f, n: bound_bf16(f, n)[0]  # noqa: E731
    rows = check_attention_bwd(dev, keys=TC_BF16_KEYS, design=design,
                               dtype=torch.bfloat16)
    rows.update(check_attention_bwd(dev, range_cases()[:1], WIDE_BF16_KEYS, design,
                                    torch.bfloat16))
    wide_launches = check_attention_module_bf16(dev, counters)
    torch.cuda.empty_cache()
    log(f"[train-bf16] kernel and module checks in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

    cfg = ModelConfig()
    cfgs = {"float32": cfg,
            "bfloat16": dataclasses.replace(cfg, train_compute_dtype="bfloat16")}
    tcfgs = {"float32": TrainConfig(), "bfloat16": TrainConfig(bf16_run=True)}
    data_cfg = DataConfig()
    models = {n: init_params(build_models(c, device="cuda"), c, seed=1234)
              for n, c in cfgs.items()}
    for a, b in zip(models["float32"][:3], models["bfloat16"][:3]):
        sa, sb = a.state_dict(), b.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            raise AssertionError("[train-bf16] the two models' weights differ")
    states = {n: init_train_state(models[n], tcfgs[n]) for n in cfgs}
    steps = {n: make_train_step(models[n], tcfgs[n], data_cfg, cfg.segment_size)
             for n in cfgs}
    gens = {n: torch.Generator(device=dev).manual_seed(tcfgs[n].seed) for n in cfgs}
    batch = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX,
                             TRAIN_TY, seed=0, dev=dev)
    lr = tcfgs["float32"].learning_rate
    n_enc = cfg.n_layers
    n_flow = cfg.n_flow_layer * cfg.n_layers_trans_flow
    want = {"float32": {"banded_attn_fwd_train": n_enc + n_flow,
                        "banded_attn_bwd_q": n_enc + n_flow,
                        "banded_attn_bwd_k": n_enc + n_flow, "mas_fwd": 1},
            "bfloat16": {"banded_attn_fwd_train": n_enc, "banded_attn_bwd_q": n_enc,
                         "banded_attn_bwd_k": n_enc, "mas_fwd": 1,
                         **{k: n_flow for k in TC_BF16_KEYS}}}

    def one_step(name):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        states[name], metrics = steps[name](states[name], batch, gens[name], lr)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        w_ = {k: 0 for k in counters}
        w_.update(want[name])
        if got != w_:
            raise AssertionError(f"[train-bf16] {name} step launched {got}, not {w_}")
        bad = {k: float(v) for k, v in metrics.items() if not math.isfinite(float(v))}
        if bad:
            raise AssertionError(f"[train-bf16] non-finite {name} metrics: {bad}")
        return sec, metrics, got

    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        first = {}
        for name in cfgs:
            torch.manual_seed(99)  # the same dropout draws in both first steps
            _, first[name], launches = one_step(name)
            log(f"[train-bf16] first {name} step: launches "
                f"{ {k: v for k, v in launches.items() if v} }; " + ", ".join(
                    f"{k} {float(v):.5g}" for k, v in sorted(first[name].items())))
        bf16_launches = launches
        rel = {k: abs(float(first["bfloat16"][k]) - float(first["float32"][k]))
               / (abs(float(first["float32"][k])) + 1e-3) for k in BF16_LOSS_REL}
        log("[train-bf16] first step, bf16 against fp32 from the same weights, batch "
            "and noise, |a - b| / (|b| + 1e-3): " + ", ".join(
                f"{k} {r:.4f} (bound {BF16_LOSS_REL[k]})" for k, r in rel.items()))
        if not all(r <= BF16_LOSS_REL[k] for k, r in rel.items()):
            raise AssertionError("[train-bf16] the bf16 step's losses are off fp32's")
        master = {str(p.dtype) for m in models["bfloat16"][:3] for p in m.parameters()}
        norms = {k: float(v) for k, v in first["bfloat16"].items()
                 if k.startswith("grad_norm")}
        log(f"[train-bf16] bf16 step: master parameters {sorted(master)} after the "
            f"update; unclipped grad norms {norms} (clipped to "
            f"{tcfgs['bfloat16'].grad_clip_g:g} for G, "
            f"{tcfgs['bfloat16'].grad_clip_d:g} for the discriminators)")
        if master != {"torch.float32"}:
            raise AssertionError(f"[train-bf16] master parameters {master}")

        times = {n: [] for n in cfgs}
        peaks = {n: 0.0 for n in cfgs}
        for name in ["float32", "bfloat16", "bfloat16", "float32"] * TRAIN_BF16_ROUNDS:
            torch.cuda.reset_peak_memory_stats()
            sec, _, _ = one_step(name)
            times[name].append(sec)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**30)
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"[train-bf16-timing] {smi}: the same batch, fused attention, "
            f"{len(times['float32'])} steps each in turns (F B B F): float32 median "
            f"{med['float32'] * 1e3:.1f} ms (max {max(times['float32']) * 1e3:.1f}), "
            f"peak {peaks['float32']:.2f} GiB; bfloat16 median "
            f"{med['bfloat16'] * 1e3:.1f} ms (max {max(times['bfloat16']) * 1e3:.1f}), "
            f"peak {peaks['bfloat16']:.2f} GiB; bf16 / fp32 "
            f"{med['bfloat16'] / med['float32']:.3f}")
        for name in cfgs:
            # kernels only: the host-side events of ~25,000 launches would
            # cost the trace tens of seconds
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall, _, _ = one_step(name)
            evs, dev_us = profile_lines(prof, wall, f"[train-bf16] one {name} step",
                                        top=8)
            log(f"[train-bf16] {name} step: {sum(e.count for e in evs)} kernels; "
                "device time by group: " + "; ".join(
                    f"{g_} {us / 1e3:.2f} ms ({100 * us / dev_us:.1f}%)"
                    for g_, us in device_groups(evs).most_common()))
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    del models, states, steps
    torch.cuda.empty_cache()
    log(f"[train-bf16] the two models' steps in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_training_forward_bf16_on_cpu(dev)
    log(f"[train-bf16] the card-vs-CPU forward in {time.perf_counter() - t0:.1f} s")
    launches = {k: bf16_launches[k] for k in TC_BF16_KEYS}
    launches.update(wide_launches)
    return rows, launches


def run_trainer_bf16(dev, smi, counters):
    """The Trainer from a config.json with "bf16_run": true (fused
    attention, no SLM): TRAINER_BF16_STEPS steps with the kernels' launches,
    finite metrics, float32 checkpoints, and the CLI resuming for one more
    step."""
    from bert_vits2_tpu_torch.train.__main__ import main as train_main
    from bert_vits2_tpu_torch.train.trainer import Trainer

    n = TRAINER_BF16_STEPS
    t_phase = time.perf_counter()
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as root:
            cfg_path = write_corpus(root, TRAINER_UTTS, bf16_run=True)
            model_dir = os.path.join(root, "model")
            trainer = Trainer(cfg_path, model_dir, slm_path=None, device="cuda")
            cfg = trainer.mcfg
            if not (cfg.train_compute_dtype == "bfloat16" and trainer.tcfg.bf16_run):
                raise AssertionError("[trainer-bf16] bf16_run did not reach the models")
            seen = {}
            step_fn = trainer.step_fn

            def spy(state, batch, generator, lr):
                out = step_fn(state, batch, generator, lr)
                seen["metrics"] = out[1]
                return out

            trainer.step_fn = spy
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            trainer.run(max_steps=n, keep_ckpts=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            metrics = trainer._assert_finite(seen["metrics"])
            n_flow = cfg.n_flow_layer * cfg.n_layers_trans_flow
            want = {k: 0 for k in counters}
            want.update({k: cfg.n_layers * n for k in (
                "banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k")})
            want.update({k: n_flow * n for k in TC_BF16_KEYS})
            want["mas_fwd"] = n
            saved = sorted(os.listdir(trainer.ckpt_dir))
            g_sd = torch.load(os.path.join(trainer.ckpt_dir, f"G_{n}.pth"),
                              map_location="cpu")["model"]
            ck_dtypes = {str(v.dtype) for v in g_sd.values() if v.is_floating_point()}
            log(f"[trainer-bf16] {n} steps of the Trainer with bf16_run in {wall:.1f} s "
                f"(first-step set-up included): launches "
                f"{ {k: v for k, v in launches.items() if v} }; step {trainer.global_step}: "
                + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items()))
                + f"; checkpoints {saved}, G's tensors {sorted(ck_dtypes)}")
            if launches != want:
                raise AssertionError(f"[trainer-bf16] launches {launches}, not {want}")
            if saved != [f"DUR_{n}.pth", f"D_{n}.pth", f"G_{n}.pth"] or ck_dtypes != {
                    "torch.float32"}:
                raise AssertionError(f"[trainer-bf16] checkpoints {saved} {ck_dtypes}")
            del trainer
            torch.cuda.empty_cache()
            resumed = train_main(["-c", cfg_path, "-m", model_dir, "--no-slm",
                                  "--max-steps", str(n + 1), "--keep-ckpts", "1"])
            saved = sorted(os.listdir(resumed.ckpt_dir))
            log(f"[trainer-bf16] the CLI resumed at step {n} in bf16 and ran to "
                f"{resumed.global_step}; checkpoints kept {saved}")
            if resumed.global_step != n + 1 or saved != [
                    f"DUR_{n + 1}.pth", f"D_{n + 1}.pth", f"G_{n + 1}.pth"]:
                raise AssertionError(f"[trainer-bf16] the resumed run: {saved}")
            del resumed
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    log(f"[trainer-bf16] phase in {time.perf_counter() - t_phase:.1f} s")
    return launches


PREP_SENTENCES = {  # [prep]'s raw corpus: JP and EN only (ZH's g2p needs jieba)
    "JP": ("こんにちは、今日はいい天気ですね。", "明日の朝、駅で友達に会います。",
           "この本はとても面白かったです。", "すみません、駅はどこですか。"),
    "EN": ("Hello world, this is a test of the training corpus.",
           "The quick brown fox jumps over the lazy dog.",
           "She sells sea shells by the sea shore every morning.",
           "Please call me when you arrive at the station."),
}
PREP_UTTS = 32  # half 22.05 kHz stereo PCM16, half 48 kHz mono float32
PREP_STEPS = 3
PREP_LOADS = 5  # load_collated_batch timings of each path, in turns


def write_raw_corpus(root, seed=0):
    """A raw corpus in the wizard's layout (data/<name>/esd.list and raw/):
    PREP_UTTS rows of PREP_SENTENCES across four speakers, 2-4.5 s each, even
    rows at 22.05 kHz stereo PCM16, odd rows at 48 kHz mono float32."""
    from scipy.io import wavfile

    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(PREP_UTTS):
        sr = 22050 if i % 2 == 0 else 48000
        n = int(sr * rng.uniform(2.0, 4.5))
        t = np.arange(n) / sr
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
        audio += 0.05 * rng.normal(size=n)
        if i % 2 == 0:
            stereo = np.stack([audio, 0.8 * audio], axis=1)
            wavfile.write(os.path.join(raw, f"u{i}.wav"), sr,
                          (stereo * 32767).astype(np.int16))
        else:
            wavfile.write(os.path.join(raw, f"u{i}.wav"), sr, audio.astype(np.float32))
        lang = ("JP", "EN")[(i // 2) % 2]  # each language in both formats
        text = PREP_SENTENCES[lang][(i // 4) % 4]
        rows.append(f"u{i}.wav|spk{i % 4}|{lang}|{text}")
    with open(os.path.join(root, "esd.list"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")


def run_prep(dev, smi, counters):
    """From a raw corpus to a served release through the port alone: the
    wizard's steps (config at batch 16, resample, text, bert with seeded
    noise, spec) in this process, the file pools with `processes=1`: a
    forked worker could inherit a lock of this process's threads, and a
    spawned one re-imports this script, torch included (the wizard took
    ~52 s so on an H100 machine against ~3 s in process: PERF.md §6). No
    child process, so nothing to hang. Then the Trainer on the wizard's
    config.json (the V2.3 model section, bf16_run as the wizard writes it,
    fused attention, no SLM) fed by the native loader, PREP_STEPS steps
    with the kernels' launches per step; load_collated_batch at the
    Trainer's batch with the native loader and with numpy, in turns; then
    save_release of G in fp32 and fp16, each served by load_tts_engine on
    the card, and mix_params of the step-0 and the last generator served
    once. Returns the launches summed over the phase's steps and calls."""
    from scipy.io import wavfile

    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.data.dataset import load_collated_batch
    from bert_vits2_tpu_torch.infer import load_tts_engine
    from bert_vits2_tpu_torch.preprocess import wizard
    from bert_vits2_tpu_torch.text.bert import RandomBertExtractor
    from bert_vits2_tpu_torch.train.trainer import Trainer
    from bert_vits2_tpu_torch.utils.model_tools import mix_params, save_release

    t_phase = time.perf_counter()
    totals = collections.Counter()
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_root = os.path.join(tmp, "data")
            write_raw_corpus(os.path.join(data_root, "demo"))
            p = wizard.get_paths("demo", data_root)
            msgs, t0 = [], time.perf_counter()
            for step, kw in (("config", {"batch_size": TRAIN_BATCH}),
                             ("resample", {"processes": 1}), ("text", {}),
                             ("bert", {}), ("spec", {"processes": 1})):
                t1 = time.perf_counter()
                msgs.append(wizard.STEPS[step]("demo", data_root=data_root, **kw))
                log(f"[prep] wizard step {step}: {msgs[-1]} "
                    f"({time.perf_counter() - t1:.1f} s)")
            prep_s = time.perf_counter() - t0
            rows = []
            for fl in (p["train"], p["val"]):
                with open(fl, encoding="utf-8") as f:
                    rows += [ln.rstrip("\n").split("|") for ln in f if ln.strip()]
            if msgs[1] != f"resampled {PREP_UTTS}/{PREP_UTTS} files" or len(rows) != PREP_UTTS:
                raise AssertionError(f"[prep] {msgs}: {len(rows)} rows")
            for path, _spk, _lang, _text, phones, _tones, _w2p in rows:
                sr, wav = wavfile.read(path)
                spec = np.load(path.replace(".wav", ".spec.npy"))
                bert = np.load(path.replace(".wav", ".bert.npy"))
                n_ph = len(phones.split(" "))
                if not (sr == 44100 and wav.ndim == 1 and wav.dtype == np.int16
                        and spec.shape == (1 + (len(wav) - 512) // 512, 1025)
                        and bert.shape == (2 * n_ph + 1, 1024)):
                    raise AssertionError(f"[prep] {path}: {sr} Hz {wav.shape} "
                                         f"{wav.dtype}, spec {spec.shape}, bert "
                                         f"{bert.shape} for {n_ph} phones")
            with open(p["config"], encoding="utf-8") as f:
                hps = json.load(f)
            log(f"[prep] {PREP_UTTS} raw files (22.05 kHz stereo PCM16 and 48 kHz "
                f"mono float32) prepared in {prep_s:.1f} s: 44.1 kHz mono PCM16, "
                f"{len(rows)} rows ({hps['data']['n_speakers']} speakers), spec "
                f"[frames, 1025] and BERT [2 * phones + 1, 1024] caches checked")

            model_dir = os.path.join(p["start"], "models")
            trainer = Trainer(p["config"], model_dir, slm_path=None, device="cuda")
            cfg, default = trainer.mcfg, ModelConfig()
            widths = ("hidden_channels", "filter_channels", "inter_channels",
                      "n_layers", "n_heads", "n_flow_layer", "n_layers_trans_flow",
                      "upsample_rates", "upsample_initial_channel", "gin_channels")
            if any(getattr(cfg, w) != getattr(default, w) for w in widths):
                raise AssertionError("[prep] the wizard's config is not at the V2.3 widths")
            if trainer.native_loader is None:
                raise AssertionError("[prep] the native batch loader is not active")
            n_flow = cfg.n_flow_layer * cfg.n_layers_trans_flow
            want = {k: 0 for k in counters}
            train_keys = ("banded_attn_fwd_train", "banded_attn_bwd_q", "banded_attn_bwd_k")
            if trainer.tcfg.bf16_run:  # the flow's attention in bf16, enc_p's in fp32
                want.update({k: cfg.n_layers for k in train_keys})
                want.update({k: n_flow for k in TC_BF16_KEYS})
            else:
                want.update({k: cfg.n_layers + n_flow for k in train_keys})
            want["mas_fwd"] = 1
            sd0 = {k: v.detach().cpu().clone()
                   for k, v in trainer.models.synthesizer.state_dict().items()}
            before = [[q.detach().clone() for q in m.parameters()]
                      for m in trainer.models[:3]]
            step_fn, seen = trainer.step_fn, {"times": [], "launches": []}

            def spy(state, batch, generator, lr):
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                out = step_fn(state, batch, generator, lr)
                torch.cuda.synchronize()
                seen["times"].append(time.perf_counter() - t0)
                seen["launches"].append({k: c.launches for k, c in counters.items()})
                seen["metrics"], seen["shape"] = out[1], tuple(batch["spec"].shape)
                return out

            trainer.step_fn = spy
            trainer.run(max_steps=PREP_STEPS, keep_ckpts=1)
            metrics = trainer._assert_finite(seen["metrics"])
            for i, got in enumerate(seen["launches"]):
                if got != want:
                    raise AssertionError(f"[prep] step {i + 1} launches {got}, not {want}")
                totals.update(got)
            moved = [sum(not torch.equal(q.detach(), o) for q, o in zip(m.parameters(), old))
                     / len(old) for m, old in zip(trainer.models[:3], before)]
            del before
            saved = sorted(os.listdir(trainer.ckpt_dir))
            n = PREP_STEPS
            step_med = float(np.median(seen["times"]))
            log(f"[prep] Trainer on the wizard's config.json ({trainer.sampler.batch_size} "
                f"a batch, bf16_run {trainer.tcfg.bf16_run}, last spec batch "
                f"{seen['shape']}): {n} steps, launches per step "
                f"{ {k: v for k, v in want.items() if v} } in every step; "
                f"step median {step_med * 1e3:.1f} ms (times "
                f"{[round(s * 1e3, 1) for s in seen['times']]}, the first with set-up); "
                f"parameters moved G/D/DUR {[round(m, 3) for m in moved]}; "
                + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items()))
                + f"; checkpoints {saved}")
            if min(moved) < 0.9 or saved != [f"DUR_{n}.pth", f"D_{n}.pth", f"G_{n}.pth"]:
                raise AssertionError(f"[prep] parameters moved {moved}, checkpoints {saved}")

            # the loader: the Trainer's batch, native and numpy in turns (warm
            # page cache: the files were just written and read)
            bucket, ids = next(iter(trainer.sampler))
            frames = trainer.sampler.bucket_max_frames(bucket)
            loader, times = trainer.native_loader, {"native": [], "numpy": []}
            if loader is None:
                raise AssertionError("[prep] the native batch loader is not active")
            batches = {}
            for _ in range(PREP_LOADS):
                for name, ld in (("native", loader), ("numpy", None)):
                    t0 = time.perf_counter()
                    batches[name] = load_collated_batch(trainer.train_ds, ids, frames,
                                                        loader=ld)
                    times[name].append(time.perf_counter() - t0)
            trainer.close()
            same = all(np.array_equal(batches["native"][k], batches["numpy"][k])
                       for k in batches["numpy"])
            med = {k: float(np.median(v)) for k, v in times.items()}
            nbytes = sum(a.nbytes for a in batches["numpy"].values())
            log(f"[prep-timing] {smi}: load_collated_batch of {len(ids)} items at "
                f"{frames} frames ({nbytes / 2**20:.1f} MiB, warm page cache), median "
                f"of {PREP_LOADS} in turns: native {med['native'] * 1e3:.2f} ms, numpy "
                f"{med['numpy'] * 1e3:.2f} ms ({med['numpy'] / med['native']:.2f}x); "
                f"the Trainer's step median {step_med * 1e3:.1f} ms; the batches equal "
                f"{same}")
            if not same:
                raise AssertionError("[prep] the native and the numpy batch differ")
            del trainer
            torch.cuda.empty_cache()

            # release and serve
            ext = RandomBertExtractor(0)
            g_path = os.path.join(model_dir, "ckpt", f"G_{n}.pth")
            source = load_tts_engine(p["config"], g_path, bert_extractor=ext, device="cuda")
            sd = source.model.state_dict()
            zero = dict(language="JP", noise_scale=0.0, noise_scale_w=0.0)
            text = PREP_SENTENCES["JP"][0]
            want_serve = {k: 0 for k in counters}
            want_serve.update(banded_attn_fwd=2 * cfg.n_layers + n_flow,
                              mrf_fwd=sum(1 for w in source.mrf_packed if w is not None))

            def served(what, engine, **kw):
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                wave = engine.infer(text, "spk1", **kw)
                torch.cuda.synchronize()
                got = {k: c.launches for k, c in counters.items()}
                if got != want_serve or not (len(wave) and np.isfinite(wave).all()):
                    raise AssertionError(f"[prep] {what}: launches {got}, "
                                         f"{len(wave)} samples")
                totals.update(got)
                return wave

            src_wave = source.infer(text, "spk1", **zero)
            for half in (False, True):
                npz = os.path.join(tmp, f"release_{'fp16' if half else 'fp32'}.npz")
                save_release(npz, sd, half=half)
                engine = load_tts_engine(p["config"], npz, bert_extractor=ext, device="cuda")
                got_sd = engine.model.state_dict()
                exact = all(torch.equal(got_sd[k], v.half().float() if half else v)
                            for k, v in sd.items() if not k.startswith("enc_q."))
                wave = served(f"release {'fp16' if half else 'fp32'}", engine, **zero)
                msg = (f"[prep] save_release(half={half}): {os.path.getsize(npz) / 2**20:.1f} "
                       f"MiB; load_tts_engine on the card: every parameter but enc_q "
                       f"{'the fp16 rounding of ' if half else ''}the checkpoint's: {exact}; "
                       f"one JP infer K1 {want_serve['banded_attn_fwd']} K2 "
                       f"{want_serve['mrf_fwd']} launches")
                if not exact:
                    raise AssertionError(msg)
                if not half:
                    cpu = load_tts_engine(p["config"], npz, bert_extractor=ext, device="cpu")
                    cpu_wave = cpu.infer(text, "spk1", **zero)
                    err = (float(np.abs(wave - cpu_wave).max())
                           if len(wave) == len(cpu_wave) else math.inf)
                    same_src = np.array_equal(wave, src_wave)
                    msg += (f"; zero noise: card vs CPU max_abs_err {err:.3e} (bound "
                            f"{WAVE_BOUND:g}), equal to the G_{n}.pth engine's wave "
                            f"{same_src}")
                    if not (err <= WAVE_BOUND and same_src):
                        raise AssertionError(msg)
                    del cpu
                log(msg)
                del engine
            mixed = os.path.join(tmp, "mixed.npz")
            save_release(mixed, mix_params(sd, sd0, voice_ratio=(0.7, 0.3),
                                           tone_ratio=(0.6, 0.4)))
            engine = load_tts_engine(p["config"], mixed, bert_extractor=ext, device="cuda")
            wave = served("mix", engine, language="JP")
            log(f"[prep] mix_params of G_{n} and the step-0 generator (voice 0.7/0.3, "
                f"tone 0.6/0.4) served once: {len(wave) / engine.sampling_rate:.2f} s of "
                f"audio, K1 {want_serve['banded_attn_fwd']} K2 {want_serve['mrf_fwd']} "
                f"launches")
            del engine, source
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)
    log(f"[prep] phase in {time.perf_counter() - t_phase:.1f} s; launches {dict(totals)}")
    return {k: totals.get(k, 0) for k in counters}


PACK_PILE = 32  # [pack]'s run_packed pile
# [pack] with the library's default algorithms: a route against itself moves a
# few fp32 ulps from call to call (2.98e-8 on waves of ~1 on an H100)
PACK_DEFAULT_BOUND = 1e-6
DIST_STEPS = 2  # [dist] (b) and (c): Trainer / step steps per run
DIST_REL_BOUND = 1e-4  # (c): the first two-rank step against the one-process one
DP_ENGINE_BOUND = 1e-5  # (d): the data-parallel engine against the single one
DIST_TIMEOUT_S = 600
# (a): the tables' gradients of two halves summed against the full batch's:
# fp32 sums over the rows in another order (relative to the largest entry);
# bf16: each half rounded once, then summed
SALT_TABLE_REL = 1e-5
SALT_CASES = ((TRAIN_BATCH, 2, TRAIN_TY, 96), (4, 1, 200, 160))  # tensor-core; wide


def per_tensor_route(engine, reqs):
    """The per-tensor route to the model, the engine's route before its
    request pool, rebuilt here as [pack]'s reference: `_batch` shipped 13
    host arrays (int64 phones, tones, languages, lengths and speakers, three
    float32 BERT arrays, four knobs) padded to the power-of-two batch, then
    ran the duration pass and synthesis on them. -> (trimmed waves, bytes
    shipped)."""
    t_x = engine._bucket(max(len(r.inputs[0]) for r in reqs))
    rows = [reqs[i] for i in engine._pad_idx(list(range(len(reqs))))]
    b = len(rows)
    ints = np.zeros((3, b, t_x), np.int64)
    feats = [np.zeros((b, t_x, np.asarray(reqs[0].inputs[3 + j]).shape[1]), np.float32)
             for j in range(3)]
    for i, r in enumerate(rows):
        n = len(r.inputs[0])
        for j in range(3):
            ints[j, i, :n] = r.inputs[j]
            feats[j][i, :n] = r.inputs[3 + j]
    host = {"x": ints[0], "tone": ints[1], "language": ints[2],
            "x_lengths": np.asarray([len(r.inputs[0]) for r in rows], np.int64),
            "sid": np.asarray([r.sid for r in rows], np.int64),
            "bert": feats[0], "ja_bert": feats[1], "en_bert": feats[2]}
    for k in ("noise_scale", "length_scale", "noise_scale_w", "sdp_ratio"):
        host[k] = np.asarray([getattr(r, k) for r in rows], np.float32)
    batch = {k: torch.from_numpy(a).to(engine.device) for k, a in host.items()}

    def gen():
        return torch.Generator(device=engine.device).manual_seed(int(reqs[0].seed))

    with torch.inference_mode():
        kw = {k: v for k, v in batch.items() if k != "noise_scale"}
        frames = engine.model.predict_durations(generator=gen(), **kw)
        frames = frames.cpu().numpy()[:len(reqs)]
        m = engine.frame_multiple
        cap = -(-int(max(int(frames.max()), 1)) // m) * m
        max_frames = min(max(cap, m),
                         engine._frame_cap(t_x, max(r.length_scale for r in reqs)))
        wave, _, _, y_len = engine.model.infer(
            max_frames=max_frames, generator=gen(), mrf_packed=engine.mrf_packed,
            stages=engine.stages, **batch)
    y_len, wave = y_len.cpu().numpy(), wave[:len(reqs)].cpu().numpy()
    lens = [min(int(y_len[i]), max_frames) * engine.hop_length for i in range(len(reqs))]
    return [wave[i, :lens[i]] for i in range(len(reqs))], sum(a.nbytes for a in host.values())


def max_diff(waves, want) -> float:
    return max(float(np.abs(a - b).max()) if len(a) == len(b) else math.inf
               for a, b in zip(waves, want))


@contextlib.contextmanager
def deterministic_algorithms(full: bool):
    """cuDNN's deterministic algorithms and, with `full`, torch's
    (`use_deterministic_algorithms`, warnings only), restored after."""
    prev = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    if full:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1], warn_only=prev[2])


def run_pack(dev, smi, counters):
    """[pack]: the engine's request pool at the default V2.3 width, fp32.
    The seed-7 batch of 8 through run_prepared with a pool and without one
    (the route packs its own), against the per-tensor route (rebuilt by
    `per_tensor_route`): with the library's default algorithms a route repeats
    itself only within a few fp32 ulps (printed), so the two routes are held
    bit for bit under deterministic algorithms (cuDNN's; torch's too if
    cuDNN's alone do not repeat). bytes_h2d per call; then PACK_PILE
    requests through run_packed: one pile shipped, each chunk a gather
    from it with no request bytes, K1 28 and K2 3 launches per chunk
    call."""
    from bert_vits2_tpu_torch.infer import TTSEngine

    t_phase = time.perf_counter()
    model = make_model("cuda")
    cfg = model.cfg
    engine = TTSEngine(model, device="cuda")
    reqs = make_requests(cfg, MAIN_BATCH, seed=7)
    n = len(reqs)
    engine.run_prepared(reqs)  # warm-up
    want, old_bytes = per_tensor_route(engine, reqs)
    spread = max_diff(per_tensor_route(engine, reqs)[0], want)
    before = engine.stats["bytes_h2d"]
    pool = engine.pack_requests(reqs)
    pair = engine.stats["bytes_h2d"] - before
    for fn in counters.values():
        fn.launches = 0
    pooled = engine.run_prepared(reqs, pool=pool, pool_rows=range(n))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    pooled_bytes = engine.stats["bytes_h2d"] - before - pair
    before = engine.stats["bytes_h2d"]
    unpooled = engine.run_prepared(reqs)
    unpooled_bytes = engine.stats["bytes_h2d"] - before
    diff = max(max_diff(pooled, want), max_diff(unpooled, want))
    for full in (False, True):  # cuDNN's deterministic algorithms, then torch's too
        with torch.inference_mode(), deterministic_algorithms(full):
            want_d = per_tensor_route(engine, reqs)[0]
            got_d = (engine.run_prepared(reqs, pool=pool, pool_rows=range(n)),
                     engine.run_prepared(reqs))
        equal = [np.array_equal(a, b) for w in got_d for a, b in zip(w, want_d)]
        log(f"[pack] deterministic algorithms ({'cuDNN and torch' if full else 'cuDNN'}"
            f"): the pool route and the unpooled one bit-equal to the per-tensor "
            f"route: "
            f"{all(equal)}")
        if all(equal):
            break
    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
    log(f"[pack] {smi}: the seed-7 batch of {n} ({sorted(len(r.inputs[0]) for r in reqs)} "
        f"tokens), the library's default algorithms: through a pool and unpooled "
        f"within {diff:.3e} of the per-tensor route, which repeats itself within "
        f"{spread:.3e}; launches of the pool call K1 {launches['banded_attn_fwd']} K2 "
        f"{launches['mrf_fwd']} (expected {n_attn} and {n_mrf}); bytes_h2d per call: "
        f"the per-tensor route {old_bytes} in 13 copies, this route {unpooled_bytes} "
        f"in 2 "
        f"(the pool's pair {pair}; a call through the pool {pooled_bytes})")
    if not all(equal):
        raise AssertionError("the pool route's waves differ from the per-tensor route")
    if diff > PACK_DEFAULT_BOUND:
        raise AssertionError("with the default algorithms the pool route lies further "
                             f"than {PACK_DEFAULT_BOUND:g} from the per-tensor route")
    if (launches["banded_attn_fwd"], launches["mrf_fwd"]) != (n_attn, n_mrf):
        raise AssertionError(f"pool call launches {launches}")
    if pooled_bytes != 0 or unpooled_bytes != pair:
        raise AssertionError("bytes_h2d: a pool call shipped bytes, or a call shipped "
                             "other than one pair")

    pile = make_requests(cfg, PACK_PILE, seed=8)
    calls = []
    run_prepared = engine.run_prepared

    def counted(*a, **k):
        # each chunk's launches as the difference of the counts around it
        before = {name: fn.launches for name, fn in counters.items()}
        out = run_prepared(*a, **k)
        calls.append((len(a[0]), *(counters[name].launches - before[name]
                                   for name in ("banded_attn_fwd", "mrf_fwd"))))
        return out

    engine.run_prepared = counted
    for fn in counters.values():
        fn.launches = 0
    before = engine.stats["bytes_h2d"]
    t0 = time.perf_counter()
    waves = engine.run_packed(pile, max_batch=MAIN_BATCH)
    packed_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    totals = collections.Counter({name: fn.launches for name, fn in counters.items()})
    shipped = engine.stats["bytes_h2d"] - before
    del engine.run_prepared
    # the whole call: the chunks, and the pile's duration pass before them
    # (the text encoder's n_layers K1 launches)
    want_total = (len(calls) * n_attn + cfg.n_layers, len(calls) * n_mrf)
    t_x = engine._bucket(max(len(r.inputs[0]) for r in pile))
    ints, floats = engine._pack_host(pile, t_x)
    ok = all(len(w) >= engine.hop_length and np.isfinite(w).all()
             and np.abs(w).max() <= 1.0 for w in waves)
    log(f"[pack] {smi}: run_packed of {PACK_PILE} requests, max_batch {MAIN_BATCH}: "
        f"{len(calls)} chunk calls (rows, K1, K2) {calls}; the whole call K1 "
        f"{totals['banded_attn_fwd']} K2 {totals['mrf_fwd']} (expected {want_total[0]} "
        f"and {want_total[1]}); bytes_h2d {shipped} (one "
        f"pair: {ints.nbytes + floats.nbytes}); waves finite in [-1, 1]: {ok}; "
        f"{packed_s:.2f} s; phase {time.perf_counter() - t_phase:.1f} s")
    if shipped != ints.nbytes + floats.nbytes or not ok or len(waves) != PACK_PILE:
        raise AssertionError("run_packed shipped other than one pair, or a wave is bad")
    if any((k1, k2) != (n_attn, n_mrf) for _, k1, k2 in calls) or (
            totals["banded_attn_fwd"], totals["mrf_fwd"]) != want_total:
        raise AssertionError(f"run_packed launches: chunks {calls}, in all {totals}")
    del engine, model
    torch.cuda.empty_cache()
    return dict(totals)


def no_module_dropout(models):
    """Module dropouts off (torch's generator, per rank), the attention's
    hash dropout kept: the two-rank step can then equal the one-process one."""
    for m in models:
        if m is not None:
            for sub in m.modules():
                if isinstance(sub, torch.nn.Dropout):
                    sub.p = 0.0
    return models


def digest(modules) -> str:
    import hashlib
    h = hashlib.sha1()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dist_step_models(device):
    """The default V2.3 models from seed 1234, module dropouts off, with their
    optimizers: (models, state)."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.train import TrainConfig, init_train_state
    from bert_vits2_tpu_torch.train.trainer import build_models, init_params

    cfg = ModelConfig()
    models = no_module_dropout(init_params(build_models(cfg, device=device), cfg,
                                           seed=1234))
    return models, init_train_state(models, TrainConfig())


def dist_worker(mode: str, out_path: str) -> int:
    """A child process of [dist]. mode "gloo": one of two ranks on cuda:0
    (torchrun's variables in the environment), DIST_STEPS data-parallel
    steps of the V2.3 models at TRAIN_BATCH / 2 rows each; mode
    "multihost": one of two ranks of the training CLI,
    `bert_vits2_tpu_torch.train --multihost`, which joins the group from
    those variables and trains the V2.3 Trainer for DIST_STEPS steps on
    DIST_MH_CONFIG's corpus (each rank's step, its launches and its saves
    recorded); mode "nccl": the only rank of an
    NCCL group, the Trainer for DIST_STEPS steps on a corpus; mode
    "plain": the same Trainer in no group. "nccl" and "plain" run the
    library's deterministic algorithms (cuDNN's and torch's, with
    CUBLAS_WORKSPACE_CONFIG set by the parent), so their parameters can be
    compared bit for bit. Writes a JSON record to out_path."""
    import torch.distributed as dist

    from bert_vits2_tpu_torch.parallel import init_distributed, make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    counters = train_counters()
    out = {}
    if mode == "multihost":
        from bert_vits2_tpu_torch.train import trainer as trainer_mod
        from bert_vits2_tpu_torch.train.__main__ import main as train_main

        record = {"times": [], "launches": [], "metrics": [], "saves": 0}

        class Recorded(trainer_mod.Trainer):
            """The CLI's Trainer, its steps timed and counted, its saves
            counted."""

            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                step_fn = self.step_fn

                def recorded(*args):
                    for fn in counters.values():
                        fn.launches = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, metrics = step_fn(*args)
                    torch.cuda.synchronize()
                    record["times"].append(time.perf_counter() - t0)
                    record["launches"].append({k: fn.launches
                                               for k, fn in counters.items()})
                    record["metrics"].append({k: float(v) for k, v in metrics.items()})
                    return state, metrics

                self.step_fn = recorded

            def save(self, *a, **k):
                record["saves"] += 1
                return super().save(*a, **k)

        trainer_mod.Trainer = Recorded
        torch.cuda.reset_peak_memory_stats()
        trainer = train_main(["-c", os.environ["DIST_MH_CONFIG"], "-m",
                              os.path.join(os.path.dirname(os.environ["DIST_MH_CONFIG"]),
                                           "run"),
                              "--multihost", "--no-slm", "--max-steps",
                              str(DIST_STEPS)])
        out.update(rank=dist.get_rank(), world=dist.get_world_size(),
                   backend=dist.get_backend(), n_data=trainer.n_data,
                   data_rank=trainer.data_rank, lead=trainer.is_lead,
                   device=str(trainer.device), step=trainer.global_step,
                   digest=digest(trainer.models[:3]),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, **record)
    elif mode in ("nccl", "plain"):
        from bert_vits2_tpu_torch.train.trainer import Trainer

        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        if mode == "nccl":
            dist.init_process_group("nccl", init_method=os.environ["DIST_INIT"],
                                    world_size=1, rank=0)
        trainer = Trainer(os.environ["DIST_CONFIG"],
                          os.path.join(os.environ["DIST_ROOT"], mode),
                          slm_path=None, device="cuda")
        step_fn, losses = trainer.step_fn, []

        def recorded(*a):
            state, metrics = step_fn(*a)
            losses.append({k: float(v) for k, v in metrics.items()})
            return state, metrics

        trainer.step_fn = recorded
        trainer.run(max_steps=DIST_STEPS, keep_ckpts=1)
        torch.cuda.synchronize()
        out.update(backend=dist.get_backend() if mode == "nccl" else None,
                   world=dist.get_world_size() if mode == "nccl" else None,
                   n_data=trainer.n_data, step=trainer.global_step,
                   device=str(trainer.device), digest=digest(trainer.models[:3]),
                   losses=losses)
    else:
        from bert_vits2_tpu_torch.config import ModelConfig
        from bert_vits2_tpu_torch.parallel.data import reduce_gradients
        from bert_vits2_tpu_torch.train import DataConfig, TrainConfig, make_train_step

        init_distributed(backend="gloo")
        rank = dist.get_rank()
        mesh = make_mesh(devices=["cuda:0", "cuda:0"])
        models, state = dist_step_models("cuda:0")
        # torch's global generator per rank, as the Trainer seeds it: the
        # hash dropout's seeds must come from the step's shared generator
        torch.manual_seed(1000 + rank)
        cfg, data_cfg = ModelConfig(), DataConfig()
        step = make_train_step(models, TrainConfig(), data_cfg, cfg.segment_size, mesh=mesh)
        full = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX, TRAIN_TY,
                                seed=0, dev="cpu")
        batch = shard_batch(mesh, full)
        gen = torch.Generator(device="cuda:0")
        times, launches, metrics = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(DIST_STEPS):
            gen.manual_seed(1234 + i)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen, TrainConfig().learning_rate)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append({k: fn.launches for k, fn in counters.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        # the collective alone: the step's three gradient all-reduces
        sizes = [sum(p.numel() for p in mod.parameters()) for mod in models[:3]]
        bufs = [[torch.zeros(n, device="cuda:0")] for n in sizes]
        for b in bufs:
            reduce_gradients(b, mesh.data_group, mesh.n_data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in bufs:
            reduce_gradients(b, mesh.data_group, mesh.n_data)
        torch.cuda.synchronize()
        out.update(rank=rank, world=dist.get_world_size(), backend=dist.get_backend(),
                   times=times, launches=launches, metrics=metrics,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   digest=digest(models[:3]), grad_floats=sizes,
                   allreduce_s=time.perf_counter() - t0)
    with open(out_path, "w") as f:
        json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def train_counters():
    from bert_vits2_tpu_torch.ops import attention
    from bert_vits2_tpu_torch.ops.align import maximum_path
    return {"banded_attn_fwd_train": attention.banded_attention_fwd_train,
            "banded_attn_bwd_q": attention.banded_attention_bwd_q,
            "banded_attn_bwd_k": attention.banded_attention_bwd_k,
            "mas_fwd": maximum_path}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(groups, root, extra_env=None):
    """Child processes of this script in dist-worker mode, every group's at
    once: groups [(mode, n), ...], each of n ranks on a free port of its own
    -> {mode: [JSON record per rank]}; a child that fails fails the phase."""
    procs = []
    for mode, n in groups:
        port = free_port()
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), DIST_INIT=f"tcp://127.0.0.1:{port}",
                       **(extra_env or {}))
            path = os.path.join(root, f"{mode}{rank}.json")
            procs.append((mode, path, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-worker", mode, path],
                env=env)))
    try:
        codes = [p.wait(timeout=DIST_TIMEOUT_S) for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"[dist] {[m for m, _ in groups]} ranks exited with {codes}")
    out = {mode: [] for mode, _ in groups}
    for mode, path, _ in procs:
        with open(path) as f:
            out[mode].append(json.load(f))
    return out


def check_salted_kernels(dev, smi, counters):
    """[dist] (a): K1's train mode, B5 and B6 with the hash dropout on each
    half of a batch, salted (row_offset * h, h), fp32 and bf16, at the flow's
    training shape (the tensor-core kernels) and at a d = 160 shape (the
    wide ones): out, dq, dk and dv bit-equal to the full batch's rows; the
    tables' gradients of the halves summed within SALT_TABLE_REL of the
    largest entry (fp32) or 8 bf16 ulps of it (bf16: each half's sum is
    rounded once, then the two added; twice the kernels' 4-ulp bound)."""
    from bert_vits2_tpu_torch.ops.attention import (
        banded_attention_bwd_k, banded_attention_bwd_q, banded_attention_fwd_train)

    w, p_drop, seed = 4, 0.1, 987653
    for b, h, t, d in SALT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(t + d)
            q, k, v, go = (torch.randn(b, h, t, d, device=dev, generator=g)
                           for _ in range(4))
            q = q / d ** 0.5
            ek, ev = (torch.randn(2 * w + 1, d, device=dev, generator=g) / d ** 0.5
                      for _ in range(2))
            m = lens_mask([t - (t // (2 * b)) * i for i in range(b)], t, dev)
            go = go * m[:, None, :, None]
            q, k, v, ek, ev, go = (a.to(dtype) for a in (q, k, v, ek, ev, go))

            def run(rows, salt):
                qq, kk, vv, mm, gg = (a[rows].contiguous() for a in (q, k, v, m, go))
                out, mr, lr = banded_attention_fwd_train(qq, kk, vv, mm, ek, ev, w,
                                                         p_drop, seed, salt)
                args = (qq, kk, vv, mm, ek, ev, gg, mr, lr,
                        (gg.float() * out.float()).sum(-1), w, p_drop, seed, salt)
                return (out, *banded_attention_bwd_q(*args),
                        *banded_attention_bwd_k(*args))

            before = {k: fn.launches for k, fn in counters.items()}
            full = run(slice(0, b), None)
            halves = [run(slice(o, o + b // 2), (o * h, h)) for o in (0, b // 2)]
            torch.cuda.synchronize()
            used = sorted(k for k, fn in counters.items() if fn.launches != before[k])
            equal = {name: torch.equal(torch.cat([hv[i] for hv in halves]), full[i])
                     for i, name in ((0, "out"), (1, "dq"), (4, "dk"), (5, "dv"))}
            errs = {}
            for i, name in ((2, "dek"), (3, "dev")):
                ref = full[i].float()
                errs[name] = (halves[0][i].float() + halves[1][i].float()
                              - ref).abs().max().item()
                bound = (SALT_TABLE_REL * ref.abs().max().item()
                         if dtype == torch.float32
                         else 2 * 4 * 2.0 ** (math.floor(math.log2(
                             ref.abs().max().item())) - 7))
                errs[name + "_bound"] = bound
            log(f"[dist] (a) {smi}: salted halves of [{b},{h},{t},{d}] "
                f"{str(dtype)[6:]}, kernels {used}: bit-equal to the full batch "
                f"{equal}; tables' gradients summed, max-abs-err " + ", ".join(
                    f"{k} {v:.3e}" for k, v in errs.items()))
            if not all(equal.values()) or any(
                    errs[n] > errs[n + "_bound"] for n in ("dek", "dev")):
                raise AssertionError("salted halves disagree with the full batch")
    torch.cuda.empty_cache()


def run_dist(dev, smi, counters):
    """[dist]: the data axis on one card. (a) the salted training kernels
    (`check_salted_kernels`); (b) one rank of an NCCL group: the Trainer's
    DIST_STEPS steps on a corpus against the Trainer outside any group, each
    in a child process with deterministic algorithms, bit-equal parameters;
    (c) two processes sharing cuda:0 over gloo, twice: the training CLI
    with --multihost for DIST_STEPS steps of TRAIN_BATCH / 2 rows per rank
    (beside (b)'s processes): launches per rank per step, metrics and
    parameters equal across the ranks, the lead's save alone; then DIST_STEPS
    data-parallel steps of the V2.3 models at TRAIN_BATCH / 2 rows per rank,
    module dropouts off and the hash dropout on: launches per rank per step,
    metrics and parameters equal across the ranks, the first step's losses
    and grad norms within DIST_REL_BOUND of the one-process step on the
    TRAIN_BATCH rows, ms per step, peak memory per rank, the gloo
    all-reduce of the step's gradients; (d) the data-parallel engine on
    [cuda:0, cuda:0] against the single engine at noise 0.667, launches per
    replica, medians in turns; (e) NCCL across two cards, where there are
    two."""
    from bert_vits2_tpu_torch.config import ModelConfig
    from bert_vits2_tpu_torch.infer import TTSEngine
    from bert_vits2_tpu_torch.parallel import make_mesh
    from bert_vits2_tpu_torch.train import DataConfig, TrainConfig, make_train_step

    t_phase = time.perf_counter()
    check_salted_kernels(dev, smi, counters)
    cfg, data_cfg = ModelConfig(), DataConfig()
    n_attn = cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    want_l = {"banded_attn_fwd_train": n_attn, "banded_attn_bwd_q": n_attn,
              "banded_attn_bwd_k": n_attn, "mas_fwd": 1}  # per rank per step
    os.environ["BV2_FUSED_ATTENTION_TRAIN"] = "1"
    try:
        with tempfile.TemporaryDirectory() as root:
            # (b) one rank over NCCL against no group, each in a process of
            # its own with deterministic algorithms; beside them, (c)'s
            # training CLI on two ranks
            t0 = time.perf_counter()
            cfg_path = write_corpus(root, TRAIN_BATCH)
            mh_root = os.path.join(root, "multihost")
            os.makedirs(mh_root)
            mh_batch = TRAIN_BATCH // 2
            env = {"DIST_CONFIG": cfg_path, "DIST_ROOT": root,
                   "DIST_MH_CONFIG": write_corpus(mh_root, 2 * mh_batch,
                                                  batch_size=mh_batch),
                   "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
            runs = spawn_ranks([("plain", 1), ("nccl", 1), ("multihost", 2)], root,
                               env)  # side by side
            (plain,), (nccl,) = runs["plain"], runs["nccl"]
            same = nccl["digest"] == plain["digest"]
            log(f"[dist] (b) {smi}: the Trainer as the one rank of a {nccl['backend']} "
                f"group (world {nccl['world']}, n_data {nccl['n_data']}, "
                f"{nccl['device']}) and in no group, {DIST_STEPS} steps each from one "
                f"corpus, deterministic algorithms: parameters bit-equal {same}; "
                f"loss/g/total {[m['loss/g/total'] for m in nccl['losses']]} against "
                f"{[m['loss/g/total'] for m in plain['losses']]}, grad_norm_g "
                f"{[m['grad_norm_g'] for m in nccl['losses']]} against "
                f"{[m['grad_norm_g'] for m in plain['losses']]}; "
                f"{time.perf_counter() - t0:.1f} s")
            if not same or nccl["step"] != DIST_STEPS:
                raise AssertionError("the NCCL rank's Trainer differs from the plain one")

            # (c) the training CLI with --multihost on two ranks sharing cuda:0
            mh = runs["multihost"]
            saved = sorted(os.listdir(os.path.join(mh_root, "run", "ckpt")))
            for r in mh:
                log(f"[dist] (c) {smi}: the training CLI with --multihost, rank "
                    f"{r['rank']} of {r['world']} ({r['backend']}: two ranks, one card; "
                    f"{r['device']}, data rank {r['data_rank']} of {r['n_data']}, lead "
                    f"{r['lead']}), {mh_batch} rows of a {2 * mh_batch}-utterance "
                    f"corpus per step, beside (b)'s processes: steps to "
                    f"{r['step']}, ms per step "
                    f"{[round(t * 1e3, 1) for t in r['times']]}, peak memory "
                    f"{r['peak_gib']:.2f} GiB, launches per step {r['launches']}, "
                    f"saves {r['saves']}")
            same_mh = (mh[0]["metrics"] == mh[1]["metrics"]
                       and mh[0]["digest"] == mh[1]["digest"])
            log(f"[dist] (c) {smi}: the CLI's ranks' metrics and parameters equal "
                f"{same_mh}; loss/g/total {[m['loss/g/total'] for m in mh[0]['metrics']]}"
                f"; the model directory's checkpoints {saved}")
            if not same_mh or [(r["step"], r["backend"]) for r in mh] != [
                    (DIST_STEPS, "gloo")] * 2:
                raise AssertionError("the --multihost ranks disagree")
            if any(lc != want_l for r in mh for lc in r["launches"]) or any(
                    len(r["launches"]) != DIST_STEPS for r in mh):
                raise AssertionError(f"--multihost launches {[r['launches'] for r in mh]}")
            if [r["saves"] for r in mh] != [1, 0] or not {
                    f"G_{DIST_STEPS}.pth", f"D_{DIST_STEPS}.pth"} <= set(saved):
                raise AssertionError(f"--multihost saves {[r['saves'] for r in mh]}, "
                                     f"files {saved}")

            # (c) two ranks of the step sharing cuda:0 over gloo
            t0 = time.perf_counter()
            models, state = dist_step_models("cuda")
            torch.manual_seed(1000)
            step = make_train_step(models, TrainConfig(), data_cfg, cfg.segment_size)
            full = make_train_batch(cfg, data_cfg.hop_length, TRAIN_BATCH, TRAIN_TX,
                                    TRAIN_TY, seed=0, dev=dev)
            gen = torch.Generator(device=dev).manual_seed(1234)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, one = step(state, full, gen, TrainConfig().learning_rate)
            one = {k: float(v) for k, v in one.items()}
            one_s = time.perf_counter() - t1
            del models, state, step, full
            torch.cuda.empty_cache()
            ranks = spawn_ranks([("gloo", 2)], root)["gloo"]
            same = (ranks[0]["metrics"] == ranks[1]["metrics"]
                    and ranks[0]["digest"] == ranks[1]["digest"])
            rel = {k: abs(ranks[0]["metrics"][0][k] - v) / max(abs(v), 1e-12)
                   for k, v in one.items()}
            worst = max(rel, key=rel.get)
            for r in ranks:
                log(f"[dist] (c) {smi}: rank {r['rank']} of {r['world']} "
                    f"({r['backend']}, cuda:0), {TRAIN_BATCH // 2} rows: ms per step "
                    f"{[round(s * 1e3, 1) for s in r['times']]}, peak memory "
                    f"{r['peak_gib']:.2f} GiB, launches per step {r['launches']}; "
                    f"the step's three gradient all-reduces ({sum(r['grad_floats'])} "
                    f"floats, {4 * sum(r['grad_floats']) / 1e6:.1f} MB) alone "
                    f"{r['allreduce_s'] * 1e3:.1f} ms")
            log(f"[dist] (c) {smi}: ranks' metrics and parameters equal {same}; the "
                f"first step against the one-process step on {TRAIN_BATCH} rows "
                f"({one_s * 1e3:.1f} ms, the first step of fresh models): largest "
                f"relative difference {rel[worst]:.3e} ({worst}; bound "
                f"{DIST_REL_BOUND:g}); " + ", ".join(
                    f"{k} {ranks[0]['metrics'][0][k]:.6g}/{one[k]:.6g}"
                    for k in ("loss/g/total", "loss/g/kl", "loss/g/dur", "grad_norm_g",
                              "grad_norm_d")) + f"; {time.perf_counter() - t0:.1f} s")
            if not same or rel[worst] > DIST_REL_BOUND:
                raise AssertionError("the two-rank step disagrees")
            if any(lc != want_l for r in ranks for lc in r["launches"]):
                raise AssertionError(f"rank launches {[r['launches'] for r in ranks]}")
    finally:
        os.environ.pop("BV2_FUSED_ATTENTION_TRAIN", None)

    # (d) the data-parallel engine on one card named twice
    t0 = time.perf_counter()
    model = make_model("cuda")
    single = TTSEngine(model, device="cuda")
    dp = TTSEngine(model, mesh=make_mesh(n_data=2, devices=["cuda:0", "cuda:0"]))
    reqs = make_requests(model.cfg, MAIN_BATCH, seed=7)
    want = single.run_prepared(reqs)
    for fn in counters.values():
        fn.launches = 0
    got = dp.run_prepared(reqs)
    torch.cuda.synchronize()
    engine_launches = {k: fn.launches for k, fn in counters.items()}
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    lens_equal = [len(g) for g in got] == [len(w) for w in want]
    times = {"single": [], "dp": []}
    for name in ["single", "dp", "dp", "single"] * 2:
        t1 = time.perf_counter()
        (single if name == "single" else dp).run_prepared(reqs)
        times[name].append(time.perf_counter() - t1)
    n_attn = 2 * model.cfg.n_layers + model.cfg.n_flow_layer * model.cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in single.mrf_packed if w is not None)
    log(f"[dist] (d) {smi}: TTSEngine on make_mesh(2, [cuda:0, cuda:0]) against the "
        f"single engine, the seed-7 batch of {MAIN_BATCH} at noise 0.667: lengths equal "
        f"{lens_equal}, wave max-abs-err {err:.3e} (bound {DP_ENGINE_BOUND:g}); "
        f"launches of one call K1 {engine_launches['banded_attn_fwd']} K2 "
        f"{engine_launches['mrf_fwd']} (2 replicas x {n_attn} and {n_mrf}); median "
        f"run_prepared single {np.median(times['single']) * 1e3:.1f} ms, mesh "
        f"{np.median(times['dp']) * 1e3:.1f} ms (S D D S x2); "
        f"{time.perf_counter() - t0:.1f} s")
    if not lens_equal or err > DP_ENGINE_BOUND:
        raise AssertionError("the data-parallel engine disagrees with the single one")
    if (engine_launches["banded_attn_fwd"], engine_launches["mrf_fwd"]) != (
            2 * n_attn, 2 * n_mrf):
        raise AssertionError(f"data-parallel engine launches {engine_launches}")
    del single, dp, model
    torch.cuda.empty_cache()

    # (e) NCCL across two cards
    n_cards = torch.cuda.device_count()
    log(f"[dist] (e) {smi}: NCCL across two cards not run: this machine shows "
        f"{n_cards} card{'s' if n_cards != 1 else ''}" if n_cards < 2 else
        f"[dist] (e) not run: {n_cards} cards, but scaling across cards belongs to the "
        f"port's benchmark")
    log(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    rank_launches = ranks[0]["launches"][0]
    return {**{k: engine_launches[k] for k in ("banded_attn_fwd", "mrf_fwd")},
            **rank_launches}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 only: build, hold every kernel against its "
                         "plain version and time it; no model phases, no ok line")
    ap.add_argument("--bf16", action="store_true",
                    help="the build, then the [bf16] phase alone (the bf16 kernels "
                         "against their plain versions, fp32 and bf16 engines in "
                         "turns); no ok line")
    ap.add_argument("--train-bf16", action="store_true",
                    help="the build, then the [train-bf16] and [trainer-bf16] "
                         "phases alone (the bf16 training kernels against their "
                         "plain versions, fp32 and bf16 steps in turns, the bf16 "
                         "Trainer); no ok line")
    ap.add_argument("--stages", action="store_true",
                    help="the build, then the [stages] and [onnx] phases alone (the "
                         "six stages and their .pt2 programs on the card, the ONNX "
                         "graphs); no ok line")
    ap.add_argument("--prep", action="store_true",
                    help="the build, then the [prep] phase alone (a raw corpus "
                         "through the wizard, the Trainer on the native loader, "
                         "releases served); no ok line")
    ap.add_argument("--pack", action="store_true",
                    help="the build, then the [pack] phase alone (the engine's "
                         "request pool); no ok line")
    ap.add_argument("--dist", action="store_true",
                    help="the build, then the [dist] phase alone (the data axis: "
                         "salted kernels, an NCCL rank, two gloo ranks on one card, "
                         "the data-parallel engine); no ok line")
    ap.add_argument("--slm-drift", type=int, metavar="STEPS",
                    help="the build, then the [train-slm] card-vs-CPU check before "
                         "and after each of STEPS SLM steps, reported; no ok line")
    ap.add_argument("--dist-worker", nargs=2, metavar=("MODE", "OUT"),
                    help=argparse.SUPPRESS)  # a child process of [dist]
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if args.dist_worker:
        return dist_worker(*args.dist_worker)
    from bert_vits2_tpu_torch import _build
    from bert_vits2_tpu_torch.infer import TTSEngine
    from bert_vits2_tpu_torch.ops.align import maximum_path
    from bert_vits2_tpu_torch.ops import attention
    from bert_vits2_tpu_torch.ops.mrf import fused_mrf, mrf_fwd_bf16

    counters = {"banded_attn_fwd": attention.banded_rel_self_attention,
                "mrf_fwd": fused_mrf, "mas_fwd": maximum_path,
                "banded_attn_fwd_train": attention.banded_attention_fwd_train,
                "banded_attn_bwd_q": attention.banded_attention_bwd_q,
                "banded_attn_bwd_k": attention.banded_attention_bwd_k,
                "banded_attn_wide_fwd": attention.wide_fwd,
                "banded_attn_wide_fwd_train": attention.wide_fwd_train,
                "banded_attn_wide_bwd_q": attention.wide_bwd_q,
                "banded_attn_wide_bwd_k": attention.wide_bwd_k,
                "banded_attn_fwd_bf16": attention.banded_attention_fwd_bf16,
                "banded_attn_wide_fwd_bf16": attention.wide_fwd_bf16,
                "mrf_fwd_bf16": mrf_fwd_bf16,
                "banded_attn_fwd_train_bf16": attention.banded_attention_fwd_train_bf16,
                "banded_attn_bwd_q_bf16": attention.banded_attention_bwd_q_bf16,
                "banded_attn_bwd_k_bf16": attention.banded_attention_bwd_k_bf16,
                "banded_attn_wide_fwd_train_bf16": attention.wide_fwd_train_bf16,
                "banded_attn_wide_bwd_q_bf16": attention.wide_bwd_q_bf16,
                "banded_attn_wide_bwd_k_bf16": attention.wide_bwd_k_bf16}
    dev = torch.device("cuda")
    smi = smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} "
        f"| {kind} x{count}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for src, text in logs.items():
        for line in text.splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
                log(f"[build] {src}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off for matmul and cuDNN: plain versions in full fp32")
    if args.bf16:
        rows, bf16_launches = run_bf16(dev, smi, counters)
        print(json.dumps({"rows": rows, "launches": bf16_launches}), flush=True)
        return 0
    if args.train_bf16:
        rows, train_bf16_launches = run_training_bf16(dev, smi, counters)
        run_trainer_bf16(dev, smi, counters)
        print(json.dumps({"rows": rows, "launches": train_bf16_launches}), flush=True)
        return 0
    if args.prep:
        print(json.dumps({"launches_prep": run_prep(dev, smi, counters)}), flush=True)
        return 0
    if args.pack:
        print(json.dumps({"launches_pack": run_pack(dev, smi, counters)}), flush=True)
        return 0
    if args.dist:
        print(json.dumps({"launches_dist": run_dist(dev, smi, counters)}), flush=True)
        return 0
    if args.slm_drift:
        print(json.dumps({"slm_drift": run_slm_drift(dev, smi, args.slm_drift)}),
              flush=True)
        return 0
    if args.stages:
        stage_launches, program_launches, model, stages = run_stages_phase(
            dev, smi, counters)
        run_onnx_phase(dev, smi, model, stages)
        print(json.dumps({"launches_stages": stage_launches,
                          "launches_stage_programs": program_launches}), flush=True)
        return 0
    k1 = check_attention(dev)
    k2 = check_mrf(dev)
    k3 = check_mas(dev)
    kb = check_attention_bwd(dev)
    torch.cuda.empty_cache()
    if args.kernels:
        print(json.dumps({"K1": k1, "K2": k2, "K3": k3, **kb}), flush=True)
        return 0

    wide_rows, wide_launches = check_attention_range(dev, counters)
    torch.cuda.empty_cache()

    model = make_model("cuda")
    cfg = model.cfg
    engine = TTSEngine(model, device="cuda")
    reqs = make_requests(cfg, MAIN_BATCH, seed=7)
    log(f"[main] default V2.3 config, {sum(p.numel() for p in model.parameters())} "
        f"parameters, {MAIN_BATCH} requests of "
        f"{sorted(len(r.inputs[0]) for r in reqs)} tokens")
    engine.run_prepared(reqs)  # warm-up: cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    waves = engine.run_prepared(reqs)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    n_attn = 2 * cfg.n_layers + cfg.n_flow_layer * cfg.n_layers_trans_flow
    n_mrf = sum(1 for w in engine.mrf_packed if w is not None)
    log(f"[main] launches {launches} (expected {n_attn} and {n_mrf}); "
        f"frames {[len(w) // engine.hop_length for w in waves]}")
    want = {k: 0 for k in counters}
    want.update(banded_attn_fwd=n_attn, mrf_fwd=n_mrf)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}")
    for w in waves:
        if not (len(w) >= engine.hop_length and np.isfinite(w).all()
                and np.abs(w).max() <= 1.0):
            raise AssertionError("a wave is empty, non-finite or out of [-1, 1]")

    one = reqs[0]._replace(noise_scale=0.0, noise_scale_w=0.0)
    gpu_wave = engine.run_prepared([one])[0]
    cpu_model = make_model("cpu", state_dict={k: v.cpu() for k, v in
                                              model.state_dict().items()})
    t0 = time.perf_counter()
    cpu_wave = TTSEngine(cpu_model, device="cpu").run_prepared([one])[0]
    cpu_s = time.perf_counter() - t0
    wave_err = float(np.abs(gpu_wave - cpu_wave).max()) if len(
        gpu_wave) == len(cpu_wave) else math.inf
    log(f"[cpu] one request of {len(one.inputs[0])} tokens, zero noise: frames "
        f"card {len(gpu_wave) // engine.hop_length} cpu "
        f"{len(cpu_wave) // engine.hop_length}, wave max_abs_err {wave_err:.3e} "
        f"(bound {WAVE_BOUND:g}); CPU run {cpu_s:.1f} s")
    if len(gpu_wave) != len(cpu_wave) or not wave_err <= WAVE_BOUND:
        raise AssertionError("card and CPU disagree")

    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(TIMED_CALLS):
        t0 = time.perf_counter()
        waves = engine.run_prepared(reqs)
        lat.append(time.perf_counter() - t0)
    audio_s = sum(len(w) for w in waves) / engine.sampling_rate
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(lat))
    log(f"[timing] {smi}: run_prepared batch {MAIN_BATCH}, {audio_s:.2f} s of "
        f"audio per call; latency over {TIMED_CALLS} calls median "
        f"{med * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms; "
        f"{audio_s / med:.1f} audio-s/s at the median; peak memory "
        f"{peak:.2f} GiB")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_prepared(reqs)
        wall = time.perf_counter() - t0
    profile_lines(prof, wall, "one run_prepared")
    del engine, model, cpu_model
    torch.cuda.empty_cache()

    pack_launches = run_pack(dev, smi, counters)

    text_launches = run_text(dev, smi, counters)
    bf16_rows, bf16_launches = run_bf16(dev, smi, counters)
    versions_launches = run_versions(dev, smi, counters)
    stage_launches, program_launches, stage_model, stages = run_stages_phase(
        dev, smi, counters)
    run_onnx_phase(dev, smi, stage_model, stages)
    del stage_model, stages
    torch.cuda.empty_cache()
    serve_launches = run_serve(smi, counters)
    run_serve_cli(smi)
    run_bert(smi)

    run_training(dev, smi, counters)
    train_bf16_rows, train_bf16_launches = run_training_bf16(dev, smi, counters)
    check_training_forward_on_cpu(dev)
    slm_launches = run_training_slm(dev, smi, counters)
    # the training entry point: its kernels' launches replace the serving
    # path's zeros
    trained = run_trainer(dev, smi, counters)
    run_trainer_slm(dev, smi, counters)
    run_trainer_bf16(dev, smi, counters)
    prep_launches = run_prep(dev, smi, counters)
    dist_launches = run_dist(dev, smi, counters)
    launches.update({k: v for k, v in trained.items() if k not in ("banded_attn_fwd",
                                                                    "mrf_fwd")})
    # the wide kernels' path is the [attention-range] phase
    launches.update(wide_launches)
    n_trainer = TRAINER_WARMUP + TRAINER_TIMED

    def entry(name, source, replaces, rows, basis, design):
        tot = lambda k: sum(r[k] * r["launches_per_call"] for r in rows)  # noqa: E731
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": tot("ms"), "device_ms": tot("device_ms"),
            "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "bound_design_ms": tot("bound_design_ms"), "design": design,
            "library_ms": None,
            "basis": basis + ": the sum over the shapes below of time x "
                             "launches per call; ms from CUDA events around "
                             "launches, device_ms from the profiler's kernel "
                             "time",
            "shapes": rows,
        }

    tc3 = ("3xTF32 on the tensor cores (wgmma m64nNk8): bound_design_ms "
           "is 3 x FLOP at 495 TFLOP/s or the bytes")

    serving = f"per run_prepared call at batch {MAIN_BATCH}"
    training = (f"per training step at batch {TRAIN_BATCH}, {TRAIN_TX} tokens and "
                f"{TRAIN_TY} frames (launches: over the Trainer's {n_trainer} steps)")

    text_basis = ("; launches_text: over the [text] phase's synthesis calls from text "
                  "(counts zeroed before each)")
    record = {"kernels": [
        entry("banded_attn_fwd", "bert_vits2_tpu_torch/csrc/banded_attn.cu",
              "bert_vits2_tpu/ops/attention_pallas.py:88", k1, serving, tc3),
        entry("mrf_fwd", "bert_vits2_tpu_torch/csrc/mrf.cu",
              "bert_vits2_tpu/ops/mrf_pallas.py:128 and :434", k2, serving, tc3),
        entry("mas_fwd", "bert_vits2_tpu_torch/csrc/mas.cu",
              "bert_vits2_tpu/ops/align_pallas.py:39", k3, training,
              "two dependent chains of max(t_y) links (frames, walk): "
              "bound_design_ms is the larger of the bytes bound and both "
              "chains at the register link (fmax+add); chain_design_ms both "
              "chains at the links the kernel takes (shuffle+fmax+add, walk "
              "step)"),
        entry("banded_attn_fwd_train", "bert_vits2_tpu_torch/csrc/banded_attn.cu",
              "bert_vits2_tpu/ops/attention_pallas.py:88 (stats, dropout)",
              kb["banded_attn_fwd_train"], training, tc3),
        entry("banded_attn_bwd_q", "bert_vits2_tpu_torch/csrc/banded_attn_bwd.cu",
              "bert_vits2_tpu/ops/attention_pallas.py:147",
              kb["banded_attn_bwd_q"], training, tc3),
        entry("banded_attn_bwd_k", "bert_vits2_tpu_torch/csrc/banded_attn_bwd.cu",
              "bert_vits2_tpu/ops/attention_pallas.py:228",
              kb["banded_attn_bwd_k"], training, tc3),
    ]}
    serve_basis = ("; launches_serve: over the [serve] phase's traffic through the "
                   "HTTP server and its micro-batcher (counts zeroed before it)")
    slm_basis = ("; launches_train_slm: per training step with the SLM losses in "
                 "the [train-slm] phase (counts zeroed before each step)")
    for row in record["kernels"][2:]:
        row["launches_train_slm"] = slm_launches[row["name"]]
        row["basis"] += slm_basis
    versions_basis = ("; launches_versions: over the [versions] phase's checked calls "
                      "of the V1.0-V2.3 families and the vits1 flow (counts zeroed "
                      "before each)")
    stages_basis = ("; launches_stages: the [stages] phase's run_stages call (counts "
                    "zeroed before it); launches_stage_programs: its six loaded .pt2 "
                    "programs run once each (counts zeroed before each)")
    for row in record["kernels"][:2]:
        row["launches_text"] = text_launches[row["name"]]
        row["launches_versions"] = versions_launches[row["name"]]
        row["launches_serve"] = serve_launches[row["name"]]
        row["launches_stages"] = stage_launches[row["name"]]
        row["launches_stage_programs"] = program_launches[row["name"]]
        row["basis"] += text_basis + versions_basis + serve_basis + stages_basis
    wide_src = "bert_vits2_tpu_torch/csrc/banded_attn_wide.cu"
    ranged = ("per MultiHeadAttention call of the [attention-range] phase (launches: "
              "that phase's, counts zeroed before it)")
    fp32 = "fp32 CUDA cores: bound_design_ms is the bound at 67 TFLOP/s or the bytes"
    for name, replaces in (
            ("banded_attn_wide_fwd", "bert_vits2_tpu/ops/attention_pallas.py:88"),
            ("banded_attn_wide_fwd_train",
             "bert_vits2_tpu/ops/attention_pallas.py:88 (stats, dropout)"),
            ("banded_attn_wide_bwd_q", "bert_vits2_tpu/ops/attention_pallas.py:147"),
            ("banded_attn_wide_bwd_k", "bert_vits2_tpu/ops/attention_pallas.py:228")):
        record["kernels"].append(entry(name, wide_src, replaces, wide_rows[name],
                                       ranged, fp32))
    bf16_design = ("bf16 on the tensor cores (wgmma m64nNk16, fp32 accumulators): "
                   "bound_ms and bound_design_ms are FLOP at 989 TFLOP/s or the "
                   "bytes of the bf16 operands")
    bf16_basis = ("launches: the bf16 run_prepared call of the [bf16] phase "
                  "(counts zeroed before it); shapes: ")
    launches.update(bf16_launches)
    for name, source, replaces, basis in (
            ("banded_attn_fwd_bf16", "bert_vits2_tpu_torch/csrc/banded_attn.cu",
             "bert_vits2_tpu/ops/attention_pallas.py:88 (bf16 operands)",
             bf16_basis + "the flow's, " + serving),
            ("mrf_fwd_bf16", "bert_vits2_tpu_torch/csrc/mrf.cu",
             "bert_vits2_tpu/ops/mrf_pallas.py:128 and :434 (bf16 operands)",
             bf16_basis + serving),
            ("banded_attn_wide_fwd_bf16", wide_src,
             "bert_vits2_tpu/ops/attention_pallas.py:88 (bf16 operands)",
             "launches: the [bf16] phase's bf16 MultiHeadAttention call of d = 160 "
             "(counts zeroed before it); per such call")):
        record["kernels"].append(entry(name, source, replaces, bf16_rows[name], basis,
                                       bf16_design))
    launches.update(train_bf16_launches)
    train_bf16_basis = ("launches: the first bf16 step of the [train-bf16] phase "
                        "(counts zeroed before it); shapes: the flow's, " + training)
    wide_bf16_basis = ("launches: the [train-bf16] phase's bf16 MultiHeadAttention "
                       "training call of d = 160 (counts zeroed before it); per such "
                       "call")
    bwd_src = "bert_vits2_tpu_torch/csrc/banded_attn_bwd.cu"
    for name, source, replaces, basis in (
            ("banded_attn_fwd_train_bf16", "bert_vits2_tpu_torch/csrc/banded_attn.cu",
             "bert_vits2_tpu/ops/attention_pallas.py:88 (stats, dropout; bf16 operands)",
             train_bf16_basis),
            ("banded_attn_bwd_q_bf16", bwd_src,
             "bert_vits2_tpu/ops/attention_pallas.py:147 (bf16 operands)",
             train_bf16_basis),
            ("banded_attn_bwd_k_bf16", bwd_src,
             "bert_vits2_tpu/ops/attention_pallas.py:228 (bf16 operands)",
             train_bf16_basis),
            ("banded_attn_wide_fwd_train_bf16", wide_src,
             "bert_vits2_tpu/ops/attention_pallas.py:88 (stats, dropout; bf16 operands)",
             wide_bf16_basis),
            ("banded_attn_wide_bwd_q_bf16", wide_src,
             "bert_vits2_tpu/ops/attention_pallas.py:147 (bf16 operands)",
             wide_bf16_basis),
            ("banded_attn_wide_bwd_k_bf16", wide_src,
             "bert_vits2_tpu/ops/attention_pallas.py:228 (bf16 operands)",
             wide_bf16_basis)):
        record["kernels"].append(entry(name, source, replaces, train_bf16_rows[name],
                                       basis, bf16_design))
    prep_basis = ("; launches_prep: over the [prep] phase's Trainer steps on the "
                  "wizard-prepared corpus and its release calls (counts zeroed before "
                  "each)")
    for row in record["kernels"]:
        if prep_launches[row["name"]]:
            row["launches_prep"] = prep_launches[row["name"]]
            row["basis"] += prep_basis
    pack_basis = (f"; launches_pack: the [pack] phase's run_packed of {PACK_PILE} "
                  "requests through one pool (its duration pass and chunk calls)")
    dist_basis = ("; launches_dist: [dist]'s data-parallel engine call on [cuda:0, "
                  "cuda:0] (both replicas) for K1 and K2, and the launches of one "
                  "rank's step of two gloo ranks for the training kernels (counts "
                  "zeroed before each)")
    for row in record["kernels"]:
        if pack_launches.get(row["name"]):
            row["launches_pack"] = pack_launches[row["name"]]
            row["basis"] += pack_basis
        if dist_launches.get(row["name"]):
            row["launches_dist"] = dist_launches[row["name"]]
            row["basis"] += dist_basis
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
