"""Analytic FLOP model of the synthesis pipeline, per stage.

A copy of `bert_vits2_tpu/utils/flops.py` (a test pins the two together).
Counts useful multiply-accumulates (2 FLOPs per MAC) of the model math,
the work inside the kernels included, so that a per-stage time on the card
can be read against the work it does.

Stage keys match compat/stages.py: emb, enc_p, sdp, dp, align, flow, dec
(`align` is the prior expansion of `run_stages`' glue).
"""

from __future__ import annotations


def infer_stage_flops(cfg, b: int, t_x: int, frames: int) -> dict[str, float]:
    h = cfg.hidden_channels
    f = cfg.filter_channels
    d = cfg.inter_channels
    fl: dict[str, float] = {}

    fl["emb"] = 0.0  # table lookup

    # text encoder: n_layers x (qkvo + conv-ffn k=3 + banded attn) + proj
    enc = cfg.n_layers * (4 * t_x * h * h + 2 * 3 * t_x * h * f
                          + 2 * t_x * t_x * h)
    enc += t_x * h * 2 * d
    fl["enc_p"] = enc

    # duration predictors. dp: 2 convs k=3 h->256 + proj (coarse).
    # sdp: 4 DDSConv stacks of 3 dilated k=3 convs at 192ch + flows (coarse).
    fl["dp"] = 2 * 3 * t_x * h * 256 + t_x * 256
    fl["sdp"] = 8 * 3 * t_x * 256 * 256

    # alignment expand: two [b,y,x]x[b,x,d] einsums (+ path gen, ~0 FLOPs)
    fl["align"] = 2 * frames * t_x * d

    # transformer-coupling flow (reverse): n_layers_trans_flow couplings
    tf_layers = getattr(cfg, "n_layers_trans_flow", 4)
    fl["flow"] = tf_layers * (
        4 * frames * h * h + 2 * 3 * frames * h * f
        + 2 * frames * frames * h / 8  # banded attn window
        + 2 * frames * h * d
    )

    # decoder: conv_pre + per-stage (ConvTranspose + MRF) + conv_post
    ch0 = cfg.upsample_initial_channel
    dec = 7.0 * frames * d * ch0
    t = frames
    c_in = ch0
    taps = sum(
        2 * len(ds) * kk
        for kk, ds in zip(cfg.resblock_kernel_sizes,
                          cfg.resblock_dilation_sizes)
    )
    for i, (u, k) in enumerate(
        zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)
    ):
        ch = ch0 // (2 ** (i + 1))
        dec += k * t * c_in * ch  # ConvTranspose MACs (t_in taps)
        t *= u
        dec += taps * t * ch * ch  # MRF convs
        c_in = ch
    dec += 7 * t * c_in * 1  # conv_post
    fl["dec"] = dec

    return {k: 2.0 * b * v for k, v in fl.items()}


def analytic_infer_flops(cfg, b: int, t_x: int, frames: int) -> float:
    """Total useful FLOPs of one batched infer call."""
    return sum(infer_stage_flops(cfg, b, t_x, frames).values())
