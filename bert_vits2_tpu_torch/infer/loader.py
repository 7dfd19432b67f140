"""Build a ready TTSEngine from config.json + weights (reference:
infer.py:84-104 get_net_g).

Counterpart of `bert_vits2_tpu/infer/loader.py`. Weights come from:

- None: random weights drawn from `seed`;
- a reference-layout `G_*.pth` (the reference's train_ms.py, or the port's
  trainer): loaded natively, after stripping the `module.` (DDP) and
  `_orig_mod.` (torch.compile) prefixes, non-strictly as the JAX import
  does: keys missing from the file keep their init and are logged, and
  missing BERT projections (older checkpoints) are zeroed. The V2.1/V2.2
  emotion quantizers' EMA buffers (vector_quantize_pytorch's
  `_codebook.initted`, `cluster_size`, `embed_avg`: training state) are
  dropped by name before the load;
- an `.npz` release of the JAX package (`utils/model_tools.py`): its
  parameter tree goes through `compat/params.py:from_jax_params`; the
  posterior encoder `enc_q`, absent from releases, keeps its init.

The config's `version` picks the family (`compat/versions.py:spec_for`;
an unknown version means 2.3), whose overrides the model config takes:
symbol table, tones, BERT inputs and emotion branch. The JAX package's
orbax train-state directories are refused (the port writes `.pth`
checkpoints). `compute_dtype` sets the model's `infer_compute_dtype` for
every family, as the JAX loader does.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from bert_vits2_tpu_torch.compat.hparams import (
    get_hparams_from_file,
    model_config_from_hparams,
)
from bert_vits2_tpu_torch.compat.versions import spec_for
from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer, build_synthesizer

logger = logging.getLogger("bert_vits2_tpu_torch")

_STRIP = ("module.", "_orig_mod.")
# vector_quantize_pytorch's EMA state under each `_codebook` (not weights)
_VQ_BUFFERS = (".initted", ".cluster_size", ".embed_avg")


def _pth_state_dict(path: str) -> dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    out, dropped = {}, []
    for key, value in sd.items():
        while key.startswith(_STRIP):
            key = key.split(".", 1)[1]
        if "._codebook." in key and key.endswith(_VQ_BUFFERS):
            dropped.append(key)
            continue
        out[key] = value.float() if value.is_floating_point() else value
    if dropped:
        logger.info("%s: dropped %d quantizer EMA buffers (training state): %s",
                    path, len(dropped), dropped)
    return out


def load_generator_params(checkpoint_path: str | None, model: Synthesizer):
    """Load G_*.pth or an .npz release into `model` in place (None: keep its
    random init). Returns load_state_dict's (missing_keys, unexpected_keys),
    or None for None."""
    if checkpoint_path is None:
        return None
    if os.path.isdir(checkpoint_path):
        raise NotImplementedError(
            f"{checkpoint_path} is a directory (an orbax train state of the JAX "
            "package); the port loads G_*.pth checkpoints and .npz releases")
    if not os.path.isfile(checkpoint_path):
        raise FileNotFoundError(checkpoint_path)
    pth = checkpoint_path.endswith(".pth")
    if checkpoint_path.endswith(".npz"):
        from bert_vits2_tpu_torch.compat.params import from_jax_params
        from bert_vits2_tpu_torch.utils.model_tools import load_release

        sd = from_jax_params(load_release(checkpoint_path))
    elif pth:
        sd = _pth_state_dict(checkpoint_path)
    else:
        raise ValueError(f"unknown checkpoint kind {checkpoint_path!r} (.pth or .npz)")
    res = model.load_state_dict(sd, strict=False)
    zeroed = [k for k in res.missing_keys if pth and "bert_proj" in k]
    with torch.no_grad():
        for key in zeroed:
            model.get_parameter(key).zero_()
    if res.missing_keys or res.unexpected_keys:
        logger.info("%s: %d keys kept their init (%d BERT projections zeroed: %s), "
                    "%d keys of the file unused", checkpoint_path,
                    len(res.missing_keys), len(zeroed), zeroed,
                    len(res.unexpected_keys))
    return res


def load_tts_engine(
    config_path: str,
    checkpoint_path: str | None = None,
    bert_extractor=None,
    seed: int = 0,
    compute_dtype: str | None = None,
    allow_noise_bert: bool = True,
    bert_paths: dict | None = None,
    device: str | torch.device = "cuda",
    **engine_kw,
):
    """config.json (+ optional weights) -> TTSEngine on `device`.

    BERT conditioning: when `bert_extractor` is None an AutoBertExtractor is
    built on the engine's device: languages with local weights (text/bert.py
    DEFAULT_BERT_PATHS, overridable via `bert_paths`) get the port's
    encoder, the rest degrade to seeded noise with a loud warning. Set
    allow_noise_bert=False to make missing weights a hard error instead
    (recommended for servers).

    compute_dtype: "float32" or "bfloat16", the model's infer_compute_dtype
    (the flow and the decoder; the weights stay float32), for every version
    family, as the JAX loader applies it; None keeps the config's.

    `mesh=` (a one-process `parallel.make_mesh`) among `engine_kw` makes the
    data-parallel engine; its first device is then the engine's and the
    BERT extractor's, in place of `device`, and its model axis splits the
    BERT encoders.
    """
    from bert_vits2_tpu_torch.infer.api import TTSEngine
    from bert_vits2_tpu_torch.text.bert import AutoBertExtractor

    mesh = engine_kw.get("mesh")
    dev = resolve_device(mesh.data_devices[0] if mesh is not None else device)
    hps = get_hparams_from_file(config_path)
    spec = spec_for(str(hps.get("version", "2.3")))
    if bert_extractor is None:
        bert_extractor = AutoBertExtractor(paths=bert_paths, allow_noise=allow_noise_bert,
                                           device=dev, mesh=mesh)
        logger.info("BERT extractors for %s: %s", config_path, bert_extractor.describe())
    mcfg = model_config_from_hparams(hps, **spec.model_overrides())
    if compute_dtype is not None:  # raises on a dtype it does not know
        mcfg = dataclasses.replace(mcfg, infer_compute_dtype=compute_dtype)
    model = build_synthesizer(mcfg, device="cpu", seed=seed)
    load_generator_params(checkpoint_path, model)
    spk2id = hps.data.get("spk2id")
    if spk2id is not None and hasattr(spk2id, "to_dict"):
        spk2id = spk2id.to_dict()
    return TTSEngine(model, spk2id=spk2id, sampling_rate=hps.data.sampling_rate,
                     bert_extractor=bert_extractor, version_spec=spec, device=dev,
                     **engine_kw)
