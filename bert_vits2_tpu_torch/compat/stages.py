"""Inference stage decomposition and export (reference: onnx_modules/V230/
models_onnx.py:896-1080 splits SynthesizerTrn into 6 ONNX graphs: _emb,
_enc_p, _sdp, _dp, _flow, _dec, consumed by MoeVS-style runtimes).

Counterpart of `bert_vits2_tpu/compat/stages.py`. `make_stages` gives the
same 6 stages over static shapes as callables that run under
`torch.inference_mode()`, each an `nn.Module` call on the model's own
submodules: `enc_p` and the flow reach kernel K1, the decoder K2 (it is
given the packed MRF weights, without which it would run its ResBlock
modules). `run_stages` glues them with `Synthesizer.infer`'s own pieces
(`sdp_noise`, `durations`, `expand_prior`), so the same inputs and noise
give infer's wave and lengths. The flow and the decoder run in the model's
`infer_compute_dtype` (`compute_stages`), as in the engine.

`export_stages` writes each stage as a `torch.export` program
(`<stage>.pt2`) with a MoeVSProject-style manifest. The kernels are the
`torch.ops.bv2.*` custom ops (`ops/library.py`), so a program exported on
the card launches K1 and K2 when it runs there; loaded on the CPU, the same
ops run the plain versions. `sdp` takes its noise as an input tensor, as
the JAX version wraps its key as a seed input.

Layouts are the port's: channel-first activations [b, c, t] and masks
[b, 1, t]; the text inputs as `Synthesizer.infer` takes them (BERT
features [b, t_x, dim]).
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from bert_vits2_tpu_torch.models.synthesizer import (
    _knob,
    cast_copy,
    durations,
    expand_prior,
    sdp_noise,
)

STAGES = ("emb", "enc_p", "sdp", "dp", "flow", "dec")


class _Emb(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.emb_g = model.emb_g

    def forward(self, sid):
        return self.emb_g(sid)


class _EncP(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.enc_p = model.enc_p

    def forward(self, x, x_lengths, tone, language, bert, ja_bert, en_bert, g,
                emo=None):
        return self.enc_p(x, x_lengths, tone, language, bert.transpose(1, 2),
                          ja_bert.transpose(1, 2), en_bert.transpose(1, 2),
                          emo=emo, g=g)


class _Sdp(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.sdp = model.sdp

    def forward(self, x_h, x_mask, g, noise_scale_w, z):
        """z [b, 2, t_x]: standard normal noise, scaled here."""
        return self.sdp.reverse(x_h, x_mask, z * _knob(noise_scale_w, 3, z), g=g)


class _Dp(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.dp = model.dp

    def forward(self, x_h, x_mask, g):
        return self.dp(x_h, x_mask, g=g)


class _Flow(nn.Module):
    def __init__(self, flow, dtype):
        super().__init__()
        self.flow, self.dtype = flow, dtype

    def forward(self, z_p, y_mask, g):
        dt = self.dtype
        return self.flow(z_p.to(dt), y_mask.to(dt), g=g.to(dt), reverse=True)


class _Dec(nn.Module):
    def __init__(self, dec, dtype, mrf_packed):
        super().__init__()
        self.dec, self.dtype, self.mrf_packed = dec, dtype, mrf_packed

    def forward(self, z, g, y_mask=None):
        dt = self.dtype
        return self.dec(z.to(dt), g=g.to(dt),
                        y_mask=None if y_mask is None else y_mask[:, 0].to(dt),
                        mrf_packed=self.mrf_packed).float()


def stage_modules(model, stages=None, mrf_packed=None) -> dict[str, nn.Module]:
    """The 6 stages as modules over the model's submodules.

    emb(sid [b]) -> g [b, gin]
    enc_p(x, x_lengths, tone, language, bert, ja_bert, en_bert, g[, emo])
        -> (x_h [b, h, t_x], m_p, logs_p [b, d, t_x], x_mask [b, 1, t_x])
    sdp(x_h, x_mask, g, noise_scale_w, z [b, 2, t_x]) -> logw [b, 1, t_x]
    dp(x_h, x_mask, g) -> logw [b, 1, t_x]
    flow(z_p [b, d, f], y_mask [b, 1, f], g) -> z   (reverse direction)
    dec(z, g, y_mask) -> wave [b, f * hop], float32

    stages: `model.compute_stages()` (made here when None); mrf_packed:
    `model.dec.pack_mrf(model.compute_dtype)` (made here when None), as the
    engine holds them."""
    flow, dec = stages if stages is not None else model.compute_stages()
    dt = model.compute_dtype
    if mrf_packed is None:
        with torch.inference_mode():
            mrf_packed = model.dec.pack_mrf(dt)
    return modules_of(model, flow, dec, dt, mrf_packed)


def modules_of(parts, flow, dec, dtype: torch.dtype, mrf_packed) -> dict[str, nn.Module]:
    """The 6 stage modules over `parts` (any module holding `emb_g`,
    `enc_p`, `sdp` and `dp`) and this flow and decoder, run in `dtype`;
    mrf_packed None runs the decoder's ResBlock modules (the ONNX export's
    float32 copy, `compat/onnx_export.py`), and `dec`'s y_mask may then be
    left out."""
    mods = {"emb": _Emb(parts), "enc_p": _EncP(parts), "sdp": _Sdp(parts),
            "dp": _Dp(parts), "flow": _Flow(flow, dtype),
            "dec": _Dec(dec, dtype, mrf_packed)}
    return {k: m.eval() for k, m in mods.items()}


def _inference(fn):
    def run(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)

    run.module = fn
    return run


def make_stages(model, stages=None, mrf_packed=None) -> dict:
    """-> dict of stage callables mirroring the ONNX export split, each run
    under torch.inference_mode(); arguments as `stage_modules`', except

    sdp(x_h, x_mask, g, noise_scale_w, generator=None, z=None): z is the
    standard normal noise [b, 2, t_x], drawn from `generator` as
    `Synthesizer.infer` draws it when None."""
    mods = stage_modules(model, stages, mrf_packed)
    out = {k: _inference(m) for k, m in mods.items()}

    @_inference
    def sdp(x_h, x_mask, g, noise_scale_w, generator=None, z=None):
        if z is None:
            z = sdp_noise(x_h, 1.0, generator)
        return mods["sdp"](x_h, x_mask, g, noise_scale_w, z)

    out["sdp"] = sdp
    return out


def run_stages(
    stages: dict,
    x, x_lengths, sid, tone, language, bert, ja_bert, en_bert,
    max_frames: int,
    noise_scale=0.667,
    length_scale=1.0,
    noise_scale_w=0.8,
    sdp_ratio=0.0,
    generator: torch.Generator | None = None,
    z_in=None,
    eps=None,
    emo=None,
):
    """Glue the 6 stages like the ONNX runner's numpy glue
    (onnx_modules/V230_OnnxInference/__init__.py) -> (wave [b, max_frames *
    hop], y_lengths [b] int32), what `Synthesizer.infer` returns for the
    same inputs and noise: the SDP noise and then the prior noise drawn
    from `generator` in infer's order, or given as infer takes them (z_in
    [b, t_x, 2] already scaled, eps [b, max_frames, inter])."""
    with torch.inference_mode():
        g = stages["emb"](sid)
        extra = () if emo is None else (emo,)
        x_h, m_p, logs_p, x_mask = stages["enc_p"](
            x, x_lengths, tone, language, bert, ja_bert, en_bert, g, *extra)
        if z_in is not None:
            logw_sdp = stages["sdp"](x_h, x_mask, g, 1.0,
                                     z=z_in.transpose(1, 2).to(x_h.dtype))
        else:
            logw_sdp = stages["sdp"](x_h, x_mask, g, noise_scale_w, generator)
        logw_dp = stages["dp"](x_h, x_mask, g)
        w = durations(logw_sdp, logw_dp, x_mask, sdp_ratio, length_scale)
        z_p, _, y_mask, y_lengths = expand_prior(
            w, m_p, logs_p, x_mask, max_frames, noise_scale, generator, eps)
        z = stages["flow"](z_p, y_mask[:, None, :], g)
        wave = stages["dec"](z * y_mask[:, None, :].to(z.dtype), g, y_mask[:, None, :])
        return wave, y_lengths


def stage_inputs(cfg, t_x: int, max_frames: int, batch: int = 1,
                 device="cpu") -> dict[str, tuple]:
    """Example inputs of each exported stage (zeros, ones for the masks and
    lengths): what `export_stages` traces and what the programs take."""
    b, dev = batch, torch.device(device)
    f32, i64 = torch.float32, torch.int64

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    gin, h, d = cfg.gin_channels, cfg.hidden_channels, cfg.inter_channels
    ja = cfg.ja_bert_dim if cfg.use_ja_bert else cfg.bert_dim
    emo = {"vq210": (z(b, dtype=i64),), "clap220": (z(b, 512),)}.get(cfg.emotion, ())
    return {
        "emb": (z(b, dtype=i64),),
        "enc_p": (z(b, t_x, dtype=i64), torch.full((b,), t_x, dtype=i64, device=dev),
                  z(b, t_x, dtype=i64), z(b, t_x, dtype=i64), z(b, t_x, cfg.bert_dim),
                  z(b, t_x, ja), z(b, t_x, cfg.bert_dim), z(b, gin), *emo),
        "sdp": (z(b, h, t_x), z(b, 1, t_x) + 1, z(b, gin), z(b) + 1, z(b, 2, t_x)),
        "dp": (z(b, h, t_x), z(b, 1, t_x) + 1, z(b, gin)),
        "flow": (z(b, d, max_frames), z(b, 1, max_frames) + 1, z(b, gin)),
        "dec": (z(b, d, max_frames), z(b, gin), z(b, 1, max_frames) + 1),
    }


def export_stages(
    model,
    out_dir: str,
    t_x: int = 128,
    max_frames: int = 1024,
    batch: int = 1,
    project_name: str = "bert_vits2_tpu",
    stages=None,
    mrf_packed=None,
) -> dict:
    """Serialize all 6 stages as `torch.export` programs (<stage>.pt2) on
    the model's device, plus a manifest.json (the MoeVSProject-config
    analogue, onnx_modules/V230/models_onnx.py:896-1080). Returns {stage:
    path}. Load them with `load_stages` (which registers the `bv2` ops)."""
    cfg = model.cfg
    os.makedirs(out_dir, exist_ok=True)
    dev = next(model.parameters()).device
    # weight norm resolved once (the values its hook computes on each call)
    # in programs of the float32 flow and decoder
    flow, dec = stages if stages is not None else model.compute_stages()
    flow, dec = (cast_copy(m, model.compute_dtype)
                 if any(hasattr(s, "weight_g") for s in m.modules()) else m
                 for m in (flow, dec))
    mods = stage_modules(model, (flow, dec), mrf_packed)
    args = stage_inputs(cfg, t_x, max_frames, batch, dev)
    paths = {}
    for name in STAGES:
        with torch.no_grad():
            prog = torch.export.export(mods[name], args[name], strict=False)
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(prog, path)
        paths[name] = path

    manifest = {
        "Folder": project_name,
        "Name": project_name,
        "Type": "BertVits",
        "Symbol": None,
        "Cleaner": {},
        "Rate": getattr(cfg, "sampling_rate", 44100),
        "Stages": {k: os.path.basename(v) for k, v in paths.items()},
        "Shapes": {"t_x": t_x, "max_frames": max_frames, "batch": batch},
    }
    with open(os.path.join(out_dir, "manifest.json"), "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, ensure_ascii=False)
    return paths


def load_stages(out_dir: str) -> dict:
    """The programs `export_stages` wrote -> {stage: callable}, each run
    under torch.inference_mode() with the inputs of `stage_inputs` (its
    `module` attribute: the program's module)."""
    import bert_vits2_tpu_torch.ops.attention  # noqa: F401 (registers the bv2 ops)
    import bert_vits2_tpu_torch.ops.mrf  # noqa: F401

    with open(os.path.join(out_dir, "manifest.json"), encoding="utf-8") as f:
        files = json.load(f)["Stages"]
    return {k: _inference(torch.export.load(os.path.join(out_dir, v)).module())
            for k, v in files.items()}
