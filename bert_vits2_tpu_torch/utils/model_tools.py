"""Release artifacts and voice mixing (reference: compress_model.py:23-63,
utils.py:428-456 mix_model).

Counterpart of `bert_vits2_tpu/utils/model_tools.py` on the port's
state_dicts. A release is the JAX package's file: an .npz of a
generator's flattened parameter leaves, keyed by the JAX package's
parameter paths joined with "/" (`compat/params.py:to_jax_params`), without
the posterior encoder `enc_q`, in fp32 or fp16. Either package's
`load_release` reads it; `infer/loader.py` turns the tree into the port's
state_dict with `from_jax_params`.
"""

from __future__ import annotations

import numpy as np

from bert_vits2_tpu_torch.compat.params import to_jax_params


def _flatten(params, prefix="") -> dict:
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_release(path: str) -> dict:
    """Load an .npz release back into a param tree (no enc_q — infer-only).
    Floating leaves come back as float32 (a release may be stored in fp16)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten({
        k: v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) else v
        for k, v in flat.items()
    })


def compress_params(state_dict: dict, half: bool = False) -> dict:
    """Strip the posterior encoder (training only; the reference's infer
    never touches enc_q, models.py:1026) and optionally cast the floating
    tensors to fp16. Returns a new state_dict."""
    kept = {k: v.detach() for k, v in state_dict.items()
            if "enc_q" not in k.split(".")}
    if half:
        kept = {k: v.half() if v.is_floating_point() else v for k, v in kept.items()}
    return kept


def save_release(path: str, state_dict: dict, half: bool = False) -> None:
    """Write the generator `state_dict` as an inference-only release (.npz),
    the JAX package's `save_release` layout: fp32 leaves cast to fp16 when
    `half`."""
    flat = _flatten(to_jax_params(compress_params(state_dict)))
    if half:
        flat = {k: v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v
                for k, v in flat.items()}
    np.savez(path, **flat)


def mix_params(
    state_dict_a: dict,
    state_dict_b: dict,
    voice_ratio: tuple[float, float] = (0.5, 0.5),
    tone_ratio: tuple[float, float] = (0.5, 0.5),
) -> dict:
    """Weighted interpolation of two voices: enc_p tensors (prosody, tone)
    mix by tone_ratio, every other one by voice_ratio. Keys only in B are
    copied (utils.py:451-453)."""
    out = {}
    for k, va in state_dict_a.items():
        va = va.detach()
        if k not in state_dict_b:
            out[k] = va.clone()
            continue
        r = tone_ratio if k.startswith("enc_p.") else voice_ratio
        out[k] = va * r[0] + state_dict_b[k].detach().to(va) * r[1]
    for k, vb in state_dict_b.items():
        if k not in out:
            out[k] = vb.detach().clone()
    return out
