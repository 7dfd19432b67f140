#!/usr/bin/env python3
"""Drive the PyTorch port's synthesis and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3: the kernels alone

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
6c. the HTTP server in process ([serve]): a ModelRegistry with the loader
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
6d. the server's CLI ([serve-cli]): `python -m
   bert_vits2_tpu_torch.serve.server --device cuda --warmup --model
   G_0.pth:config.json` in a subprocess on a free port; it must print its
   `serving on` line, answer GET /status and two POST /voice (the first
   also loads the EN g2p's lexicon) with a WAV of a whole number of
   frames, and is terminated.
6e. the BERT encoder (text/bert_encoder.py) at the published widths of
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
8. the training forward at a cut depth, dropout off, the same noise, on the
   card and on the CPU: equal alignments, losses and waves within bounds.
9. the training entry point: the Trainer (the CLI's) on a synthetic 44.1
   kHz corpus and a config.json with the V2.3 model section, fused
   attention, no SLM: K1-train/B5/B6 and MAS launches per step, finite
   metrics, moved parameters, a checkpoint; step time, peak memory, a
   profile of one step; then the CLI resumes on the same directory.

The last three lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
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


def check_attention(dev, cases=None, label="K1", design=bound_3xtf32):
    """The inference launch against the plain version, timed: K1 at the
    serving path's shapes, or (cases) the wide kernel at its own."""
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
        m = lens_mask([t - (t // 16) * i for i in range(b)], t, dev)
        args = (q, k, v, m, ek, ev, w)
        with torch.inference_mode():
            got = banded_rel_self_attention(*args)
            want = banded_attention_plain(*args)
            torch.cuda.synchronize()
            valid = m.bool()[:, None, :, None].expand_as(got)
            err = (got - want).abs()[valid].max().item()
            ms = cuda_ms(lambda: banded_rel_self_attention(*args))
            dms = device_ms(lambda: banded_rel_self_attention(*args))
            plain = cuda_ms(lambda: banded_attention_plain(*args))
        flops = 4 * b * h * t * t * d + 4 * b * h * t * (2 * w + 1) * d
        nbytes = 4 * (4 * b * h * t * d + b * t + 2 * (2 * w + 1) * d)
        bms, by = bound(flops, nbytes)
        tc = design(flops, nbytes)
        log(f"{label} {name} [b={b},h={h},t={t},d={d},w={w}]: max_abs_err {err:.3e} "
            f"(bound {K1_BOUND:g}), kernel {ms:.4f} ms (device {dms:.4f} ms), "
            f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s fp32, {nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s), design bound {tc:.4f} ms")
        if not err <= K1_BOUND:
            raise AssertionError(f"{label} {name}: max_abs_err {err} > {K1_BOUND}")
        rows.append(dict(shape=[b, h, t, d], launches_per_call=n_main, err=err,
                         ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                         bound_by=by, bound_design_ms=tc))
    return rows


def check_attention_bwd(dev, cases=None, keys=TC_KEYS, design=bound_3xtf32):
    """K1 in train mode, B5 and B6 (or, with cases and keys, the wide
    kernels) against the plain version's autograd on the card: out, the
    row statistics and the five gradients on valid rows, without and with
    the hash dropout (one seed)."""
    from bert_vits2_tpu_torch.ops.attention import (
        banded_attention_bwd_plain, banded_attention_bwd_q,
        banded_attention_bwd_k, banded_attention_fwd_train,
        banded_attention_plain, banded_attention_stats_plain)
    rows = {key: [] for key in keys}
    seed = -1234567
    # the flow and enc_p of the training batch, launches per step; one
    # ragged odd length over several key tiles
    for name, b, h, t, d, w, n_main in cases or (
            ("flow", TRAIN_BATCH, 2, TRAIN_TY, 96, 4, N_FLOW_ATTN),
            ("enc_p", TRAIN_BATCH, 2, TRAIN_TX, 96, 4, N_ENC_ATTN),
            ("ragged", 2, 2, 1001, 96, 4, 0)):
        g = torch.Generator(device=dev).manual_seed(t)
        q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g)
                   for _ in range(3))
        q = q / math.sqrt(d)
        ek, ev = (torch.randn(2 * w + 1, d, device=dev, generator=g)
                  / math.sqrt(d) for _ in range(2))
        m = lens_mask([t - (t // 16) * i for i in range(b)], t, dev)
        go = torch.randn(b, h, t, d, device=dev, generator=g) * m[:, None, :, None]
        valid = m.bool()[:, None, :]
        for p_drop in (0.0, 0.1):
            args = (q, k, v, m, ek, ev, w, p_drop, seed)
            fwd = lambda: banded_attention_fwd_train(*args)  # noqa: E731
            out, mr, lr = fwd()
            delta = (go * out).sum(-1)
            bargs = (q, k, v, m, ek, ev, go, mr, lr, delta, w, p_drop, seed)
            dq, dek, dvv = banded_attention_bwd_q(*bargs)
            dk, dv = banded_attention_bwd_k(*bargs)
            want_out = banded_attention_plain(*args[:7], p_drop, seed)
            want_m, want_l = banded_attention_stats_plain(q, k, m, ek, w)
            want = banded_attention_bwd_plain(q, k, v, m, ek, ev, go, w, p_drop,
                                              seed)
            torch.cuda.synchronize()

            errs, abs_errs = {}, {}
            for key, got, ref in zip(
                    ("m", "l", "dq", "dk", "dv", "dek", "dev"),
                    (mr, lr, dq, dk, dv, dek, dvv), (want_m, want_l, *want)):
                if got.dim() > 2:  # valid rows only
                    got, ref = got[valid.expand(b, h, t)], ref[valid.expand(b, h, t)]
                abs_errs[key] = (got - ref).abs().max().item()
                errs[key] = abs_errs[key] / ref.abs().max().item()
            out_err = (out - want_out).abs()[valid.expand(b, h, t)].max().item()
            log(f"{'/'.join(keys)} {name} [b={b},h={h},t={t},d={d},w={w}] p_drop "
                f"{p_drop}: out max_abs_err {out_err:.3e} (bound {K1_BOUND:g}); "
                "relative to the max: " + ", ".join(
                    f"{k_} {e:.2e}" for k_, e in errs.items())
                + f" (bound {BWD_REL_BOUND:g})")
            if not (out_err <= K1_BOUND
                    and all(e <= BWD_REL_BOUND for e in errs.values())):
                raise AssertionError(f"{'/'.join(keys)} {name} p_drop {p_drop} "
                                     f"disagree with the plain autograd")
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
            leaves = [a.detach().requires_grad_() for a in (q, k, v, ek, ev)]
            with torch.enable_grad():
                o = banded_attention_plain(leaves[0], leaves[1], leaves[2], m,
                                           leaves[3], leaves[4], w, p_drop, seed)
                plain_b = cuda_ms(lambda: torch.autograd.grad(
                    o, leaves, go, retain_graph=True), iters=5)
            del o, leaves
            nb = 2 * w + 1
            io = 4 * (b * t + 2 * nb * d)  # mask and the tables
            fwd_flops = 4 * b * h * t * t * d + 4 * b * h * t * nb * d
            fwd_bytes = io + 4 * (4 * b * h * t * d + 2 * b * h * t)
            fwd_b = bound(fwd_flops, fwd_bytes)
            # B5: s, g.v, ds.k; B6: s, g.v, p.g, ds.q (+ the band terms)
            q_work = (6 * b * h * t * t * d + 6 * b * h * t * nb * d,
                      io + 4 * (5 * b * h * t * d + 3 * b * h * t) + 8 * nb * d)
            k_work = (8 * b * h * t * t * d + 4 * b * h * (t + 2 * w) * nb * d,
                      io + 4 * (6 * b * h * t * d + 3 * b * h * t))
            # the tensor-core kernels run their products as 3xTF32, the
            # wide ones on the fp32 cores (design)
            for key, ms, dms, plain, (bms, by), tc, outs in (
                    (keys[0], ms_f, dev_f, plain_f, fwd_b,
                     design(fwd_flops, fwd_bytes), ("m", "l")),
                    (keys[1], ms_q, dev_q, plain_b, bound(*q_work),
                     design(*q_work), ("dq", "dek", "dev")),
                    (keys[2], ms_k, dev_k, plain_b, bound(*k_work),
                     design(*k_work), ("dk", "dv"))):
                log(f"{key} {name} [b={b},h={h},t={t},d={d},w={w}] p_drop {p_drop}: "
                    f"kernel {ms:.4f} ms (device {dms:.4f} ms), plain "
                    f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), design bound "
                    f"{tc:.4f} ms")
                err = max(abs_errs[o] for o in outs)
                if key == keys[0]:
                    err = max(err, out_err)
                rows[key].append(dict(
                    shape=[b, h, t, d], launches_per_call=n_main, err=err,
                    ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, bound_design_ms=tc))
            del bargs
        torch.cuda.empty_cache()
    log("[kernels] plain time of B5 and of B6: the plain version's autograd "
        "backward, which computes both kernels' outputs in one pass")
    return rows


def check_mrf(dev):
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
        wts = prepare_mrf_weights([blk.to(dev) for blk in blocks])
        g = torch.Generator(device=dev).manual_seed(c)
        x = torch.randn(MAIN_BATCH, c, t, device=dev, generator=g)
        m = lens_mask([t - up * 37 * i for i in range(MAIN_BATCH)], t, dev)
        with torch.inference_mode():
            got = fused_mrf(x, m, wts)
            want = fused_mrf_plain(x, m, wts)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            masked = got[m[:, None, :].expand_as(got) == 0].abs().max().item()
            del got, want
            ms = cuda_ms(lambda: fused_mrf(x, m, wts), iters=5)
            dms = device_ms(lambda: fused_mrf(x, m, wts), iters=3)
            plain = cuda_ms(lambda: fused_mrf_plain(x, m, wts), iters=3, warmup=1)
        macs = sum(2 * c * c * k * len(dd) for k, dd in zip(ks, ds))
        flops = 2 * macs * MAIN_BATCH * t
        nbytes = 4 * (2 * MAIN_BATCH * c * t + MAIN_BATCH * t + wts.flat.numel())
        bms, by = bound(flops, nbytes)
        tc = bound_3xtf32(flops, nbytes)
        log(f"K2 C={c} [B={MAIN_BATCH},T={t}]: max_abs_err {err:.3e} "
            f"(bound {K2_BOUND:g}), masked outputs max |y| {masked:.1e} (must "
            f"be 0), kernel {ms:.3f} ms (device {dms:.3f} ms), plain "
            f"{plain:.3f} ms, bound {bms:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP "
            f"at 67 TFLOP/s fp32, {nbytes / 1e6:.1f} MB at 3.35 TB/s), 3xTF32 "
            f"bound {tc:.3f} ms (3 x FLOP at 495 TFLOP/s)")
        if not (err <= K2_BOUND and masked == 0.0):
            raise AssertionError(f"K2 C={c}: max_abs_err {err} > {K2_BOUND} "
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


def write_corpus(root, n_utts, seed=0):
    """A synthetic corpus for the Trainer: 44.1 kHz int16 wavs of 401-500
    frames (one bucket of the sampler), 40-63 phones each (128 text slots
    after the blanks), cached BERT features, a cleaned filelist in three
    languages and four speakers, and a config.json with the V2.3 model
    section. Returns the config path."""
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
                   batch_size=TRAIN_BATCH, bf16_run=False, lr_decay=0.99995,
                   segment_size=16384, c_mel=45, c_kl=1.0),
        data=dict(training_files=filelist, validation_files=filelist,
                  sampling_rate=sr, filter_length=2048, hop_length=hop,
                  win_length=2048, n_mel_channels=128, mel_fmin=0.0,
                  mel_fmax=None, add_blank=True, n_speakers=256,
                  spk2id={f"spk{i}": i for i in range(4)}),
        model=V23_MODEL_JSON,
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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1-3 only: build, hold every kernel against its "
                         "plain version and time it; no model phases, no ok line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from bert_vits2_tpu_torch import _build
    from bert_vits2_tpu_torch.infer import TTSEngine
    from bert_vits2_tpu_torch.ops.align import maximum_path
    from bert_vits2_tpu_torch.ops import attention
    from bert_vits2_tpu_torch.ops.mrf import fused_mrf

    counters = {"banded_attn_fwd": attention.banded_rel_self_attention,
                "mrf_fwd": fused_mrf, "mas_fwd": maximum_path,
                "banded_attn_fwd_train": attention.banded_attention_fwd_train,
                "banded_attn_bwd_q": attention.banded_attention_bwd_q,
                "banded_attn_bwd_k": attention.banded_attention_bwd_k,
                "banded_attn_wide_fwd": attention.wide_fwd,
                "banded_attn_wide_fwd_train": attention.wide_fwd_train,
                "banded_attn_wide_bwd_q": attention.wide_bwd_q,
                "banded_attn_wide_bwd_k": attention.wide_bwd_k}
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

    text_launches = run_text(dev, smi, counters)
    serve_launches = run_serve(smi, counters)
    run_serve_cli(smi)
    run_bert(smi)

    run_training(dev, smi, counters)
    check_training_forward_on_cpu(dev)
    # the training entry point: its kernels' launches replace the serving
    # path's zeros
    trained = run_trainer(dev, smi, counters)
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
    for row in record["kernels"][:2]:
        row["launches_text"] = text_launches[row["name"]]
        row["launches_serve"] = serve_launches[row["name"]]
        row["basis"] += text_basis + serve_basis
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
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
