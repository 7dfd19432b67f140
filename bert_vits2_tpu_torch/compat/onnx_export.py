"""ONNX artifact export for the MoeVS deployment ecosystem.

Counterpart of `bert_vits2_tpu/compat/onnx_export.py`, with its 6-graph
split and I/O contract, which mirror the reference's exactly
(onnx_modules/V230/models_onnx.py:896-1080):

  {name}_emb.onnx    sid:int64[b]                        -> g[b, gin]
  {name}_enc_p.onnx  x, x_lengths, t, language (int64),
                     bert_0/1/2 [t_x, 1024], g [b,gin,1] -> xout[b,h,t],
                                                            m_p[b,d,t],
                                                            logs_p[b,d,t],
                                                            x_mask[b,1,t]
  {name}_sdp.onnx    x[b,h,t], x_mask[b,1,t],
                     zin[b,2,t], g[b,gin,1]              -> logw[b,1,t]
  {name}_dp.onnx     x[b,h,t], x_mask[b,1,t], g[b,gin,1] -> logw[b,1,t]
  {name}_flow.onnx   z_p[b,d,t'], y_mask[b,1,t'],
                     g[b,gin,1]                          -> z[b,d,t']
  {name}_dec.onnx    z_in[b,d,t'], g[b,gin,1]            -> o[b,1,samples]

The V2.1 (`vq210`) enc_p takes `vqidx, sid` more, the V2.2 (`clap220`) one
`emo`. The boundary tensors are channel-first, the port's own layout.
Graphs are static-shape at the exported (t_x, max_frames) bucket:
re-export per bucket if a runtime needs several.

The graphs come from `compat/torch2onnx.py` (torch.export of float32 copies
of the stages with weight norm resolved, the plain functions in place of the
kernels, run on the CPU: no card needed), are serialized by
`compat/onnx_pb.py` and verified by the numpy evaluator
(`compat/onnx_eval.py`) against the torch stages.

    python -m bert_vits2_tpu_torch.compat.onnx_export -c config.json -m G_0.pth [--verify]
"""

from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np
import torch
from torch import nn

from bert_vits2_tpu_torch.compat.stages import STAGES, modules_of
from bert_vits2_tpu_torch.compat.torch2onnx import export_model
from bert_vits2_tpu_torch.models.synthesizer import cast_copy
from bert_vits2_tpu_torch.ops.library import plain_functions

_BERT_DIM = 1024

# the shape and dtype of one graph input
Spec = collections.namedtuple("Spec", "shape dtype")


class _Contract(nn.Module):
    """A stage module of `compat/stages.py` behind the reference's ONNX
    I/O layout: `adapt(stage, *graph inputs)` calls it."""

    def __init__(self, stage: nn.Module, adapt):
        super().__init__()
        self.stage, self.adapt = stage, adapt

    def forward(self, *args):
        return self.adapt(self.stage, *args)


# graph inputs -> the stage's: bert [t_x, 1024] to [1, t_x, 1024], g [b, gin,
# 1] to [b, gin], zin already scaled (noise_scale_w 1), a dec without y_mask
# and an output [b, 1, samples]. The V210 enc_p (onnx_modules/V210/
# models_onnx.py:947) takes vqidx and sid, the V220 one emo: the first is the
# emotion input (the speaker enters through g; sid is for drop-in parity).
_LAYOUT = {
    "emb": lambda s, sid: s(sid),
    "enc_p": lambda s, x, x_lengths, t, language, b0, b1, b2, g, *extra: s(
        x, x_lengths, t, language, b0[None], b1[None], b2[None], g[..., 0], *extra[:1]),
    "sdp": lambda s, x, x_mask, zin, g: s(x, x_mask, g[..., 0], 1.0, zin),
    "dp": lambda s, x, x_mask, g: s(x, x_mask, g[..., 0]),
    "flow": lambda s, z_p, y_mask, g: s(z_p, y_mask, g[..., 0]),
    "dec": lambda s, z_in, g: s(z_in, g[..., 0])[:, None, :],
}


def make_onnx_stage_fns(model) -> dict[str, nn.Module]:
    """The stage modules of `compat/stages.py` with the reference ONNX I/O
    contract, over a float32 CPU copy of the model's inference modules with
    weight norm resolved and the decoder's ResBlock modules (the exported
    graphs are float32 whatever the model's infer_compute_dtype)."""
    keep = nn.Module()
    for name in ("enc_p", "sdp", "dp", "flow", "dec", "emb_g"):
        setattr(keep, name, getattr(model, name))
    m = cast_copy(keep, torch.float32).cpu()
    mods = modules_of(m, m.flow, m.dec, torch.float32, None)
    return {k: _Contract(mods[k], _LAYOUT[k]) for k in STAGES}


def stage_signatures(cfg, t_x: int, max_frames: int, batch: int = 1):
    """-> {stage: (input specs, input_names, output_names)}."""
    f32, i64 = torch.float32, torch.int64
    b = batch
    gin, h, d = cfg.gin_channels, cfg.hidden_channels, cfg.inter_channels
    g = Spec((b, gin, 1), f32)
    bert = Spec((t_x, _BERT_DIM), f32)
    emotion = getattr(cfg, "emotion", "none")
    return {
        "emb": ((Spec((b,), i64),), ["sid"], ["g"]),
        "enc_p": (
            (Spec((b, t_x), i64), Spec((b,), i64), Spec((b, t_x), i64),
             Spec((b, t_x), i64), bert, bert, bert, g)
            + {"vq210": (Spec((b,), i64), Spec((b,), i64)),
               "clap220": (Spec((b, 512), f32),)}.get(emotion, ()),
            ["x", "x_lengths", "t", "language", "bert_0", "bert_1", "bert_2", "g"]
            + {"vq210": ["vqidx", "sid"], "clap220": ["emo"]}.get(emotion, []),
            ["xout", "m_p", "logs_p", "x_mask"],
        ),
        "sdp": ((Spec((b, h, t_x), f32), Spec((b, 1, t_x), f32),
                 Spec((b, 2, t_x), f32), g),
                ["x", "x_mask", "zin", "g"], ["logw"]),
        "dp": ((Spec((b, h, t_x), f32), Spec((b, 1, t_x), f32), g),
               ["x", "x_mask", "g"], ["logw"]),
        "flow": ((Spec((b, d, max_frames), f32), Spec((b, 1, max_frames), f32), g),
                 ["z_p", "y_mask", "g"], ["z"]),
        "dec": ((Spec((b, d, max_frames), f32), g), ["z_in", "g"], ["o"]),
    }


def _example(spec: Spec) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype)


def export_onnx(
    model,
    out_dir: str,
    name: str = "BertVits2",
    t_x: int = 128,
    max_frames: int = 1024,
    stages: tuple[str, ...] = STAGES,
    fns: dict | None = None,
) -> dict[str, str]:
    """Export the 6 inference stages as .onnx files. -> {stage: path}.

    Writes `{out_dir}/{name}_{stage}.onnx` plus a MoeVS-style project
    config `{out_dir}/config.json` (reference export naming:
    onnx_modules/V230/models_onnx.py:953-1060, export_onnx.py:4-15).
    fns: `make_onnx_stage_fns(model)`, made here when None."""
    cfg = model.cfg
    os.makedirs(out_dir, exist_ok=True)
    fns = fns or make_onnx_stage_fns(model)
    sigs = stage_signatures(cfg, t_x, max_frames)
    paths: dict[str, str] = {}
    for stage in stages:
        specs, in_names, out_names = sigs[stage]
        mb = export_model(
            fns[stage], [_example(s) for s in specs], in_names, out_names,
            graph_name=f"{name}_{stage}",
            doc_string=(f"Bert-VITS2 {stage} stage (PyTorch port export; "
                        f"t_x={t_x}, max_frames={max_frames})"),
        )
        path = os.path.join(out_dir, f"{name}_{stage}.onnx")
        with open(path, "wb") as f:
            f.write(mb)
        paths[stage] = path

    config = {
        "Folder": name,
        "Name": name,
        "Type": "BertVits",
        "Rate": getattr(cfg, "sampling_rate", 44100),
        "NSFF0": False,
        "Symbol": None,
        "AddBlank": True,
        "Hop": cfg.hop_length,
        "Characters": [],
        "LanguageMap": {"ZH": 0, "JP": 1, "EN": 2},
        "Dict": "BasicDict",
        "BertPath": [
            "chinese-roberta-wwm-ext-large",
            "deberta-v2-large-japanese",
            "bert-base-japanese-v3",
        ],
        "Clean": True,
        "Stages": {k: os.path.basename(v) for k, v in paths.items()},
        "Shapes": {"t_x": t_x, "max_frames": max_frames, "batch": 1},
    }
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
    return paths


def random_stage_inputs(cfg, t_x: int, max_frames: int, seed: int = 0) -> dict:
    """{stage: [numpy inputs]}: the random inputs `verify_onnx` draws (the
    JAX package's draws, in its order)."""
    sigs = stage_signatures(cfg, t_x, max_frames)
    rng = np.random.default_rng(seed)
    out = {}
    for stage in STAGES:
        specs, in_names, _ = sigs[stage]
        args = []
        for s, nm in zip(specs, in_names):
            if not s.dtype.is_floating_point:
                hi = {"sid": cfg.n_speakers, "x": cfg.n_vocab, "t": cfg.num_tones,
                      "language": cfg.num_languages}.get(nm, 2)
                if nm == "x_lengths":
                    args.append(np.full(s.shape, t_x, np.int64))
                else:
                    args.append(rng.integers(0, hi, s.shape).astype(np.int64))
            elif nm in ("x_mask", "y_mask"):
                args.append(np.ones(s.shape, np.float32))
            else:
                args.append((rng.normal(size=s.shape) * 0.3).astype(np.float32))
        out[stage] = args
    return out


def verify_onnx(
    model,
    paths: dict[str, str],
    t_x: int,
    max_frames: int,
    seed: int = 0,
    fns: dict | None = None,
) -> dict[str, float]:
    """Run each exported graph on the numpy evaluator against the torch
    stage with random inputs. -> {stage: max_abs_err}."""
    from bert_vits2_tpu_torch.compat.onnx_eval import OnnxEvaluator

    fns = fns or make_onnx_stage_fns(model)
    inputs = random_stage_inputs(model.cfg, t_x, max_frames, seed)
    errs: dict[str, float] = {}
    for stage, path in paths.items():
        args = inputs[stage]
        with plain_functions(), torch.no_grad():
            want = fns[stage](*[torch.from_numpy(a) for a in args])
        want = want if isinstance(want, (tuple, list)) else (want,)
        with open(path, "rb") as f:
            got = OnnxEvaluator(f.read())(*args)
        errs[stage] = max(float(np.abs(w.numpy() - g).max()) for w, g in zip(want, got))
    return errs


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export Bert-VITS2 inference stages to ONNX "
        "(reference: export_onnx.py); runs on the CPU")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model", required=True, help="G_*.pth or an .npz release")
    p.add_argument("-o", "--out", default="onnx")
    p.add_argument("--name", default="BertVits2.3PT")
    p.add_argument("--t-x", type=int, default=128)
    p.add_argument("--max-frames", type=int, default=1024)
    p.add_argument("--verify", action="store_true")
    args = p.parse_args(argv)

    from bert_vits2_tpu_torch.compat.hparams import (
        get_hparams_from_file,
        model_config_from_hparams,
    )
    from bert_vits2_tpu_torch.compat.versions import spec_for
    from bert_vits2_tpu_torch.infer.loader import load_generator_params
    from bert_vits2_tpu_torch.models import build_synthesizer

    hps = get_hparams_from_file(args.config)
    spec = spec_for(str(hps.get("version", "2.3")))
    mcfg = model_config_from_hparams(hps, **spec.model_overrides())
    model = build_synthesizer(mcfg, device="cpu")
    load_generator_params(args.model, model)
    fns = make_onnx_stage_fns(model)
    out_dir = os.path.join(args.out, args.name)
    paths = export_onnx(model, out_dir, args.name, args.t_x, args.max_frames, fns=fns)
    print(json.dumps(paths, indent=2))
    if args.verify:
        errs = verify_onnx(model, paths, args.t_x, args.max_frames, fns=fns)
        print(json.dumps({"max_abs_err": errs}, indent=2))


if __name__ == "__main__":
    main()
