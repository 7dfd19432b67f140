"""Release artifacts (reference: compress_model.py:23-63).

A copy of the reading half of `bert_vits2_tpu/utils/model_tools.py`: a
release is an .npz of a generator's flattened parameter leaves, keyed by
the JAX package's parameter paths joined with "/", without the posterior
encoder `enc_q`. `infer/loader.py` turns the tree into the port's
state_dict with `compat/params.py:from_jax_params`.
"""

from __future__ import annotations

import numpy as np


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
