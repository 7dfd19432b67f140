"""Static-shape batch collation (reference: data_utils.py:185-274).

The reference pads to the longest item per batch (dynamic shapes). The JAX
package pads to per-bucket static caps instead (text to the next multiple of
`text_pad_multiple`, spec frames to the bucket's upper boundary), so few
shapes exist; the port keeps the same batches, which also keeps the card's
allocator to a few sizes.

A copy of `bert_vits2_tpu/data/collate.py`; a test pins the two together.
"""

from __future__ import annotations

import numpy as np



def bucket_shape(max_frames: int, max_text: int, text_pad_multiple: int = 32):
    """Round text cap up to a multiple so few distinct shapes exist."""
    t = ((max_text + text_pad_multiple - 1) // text_pad_multiple) * text_pad_multiple
    return max_frames, t


def collate_batch(
    items: list[dict],
    max_frames: int,
    max_text: int | None = None,
    hop_length: int = 512,
    text_pad_multiple: int = 32,
) -> dict:
    """Zero-pad a list of dataset items into one fixed-shape numpy batch.

    Returns the train-step batch dict: x, x_lengths, spec, spec_lengths,
    wave, sid, tone, language, bert, ja_bert, en_bert.
    """
    b = len(items)
    bert_dim = items[0]["bert"].shape[1]
    if max_text is None:
        max_text = max(len(it["phones"]) for it in items)
    _, t_x = bucket_shape(max_frames, max_text, text_pad_multiple)
    t_y = max_frames
    n_samples = t_y * hop_length
    spec_ch = items[0]["spec"].shape[1]

    out = {
        "x": np.zeros((b, t_x), np.int32),
        "x_lengths": np.zeros((b,), np.int32),
        "tone": np.zeros((b, t_x), np.int32),
        "language": np.zeros((b, t_x), np.int32),
        "bert": np.zeros((b, t_x, bert_dim), np.float32),
        "ja_bert": np.zeros((b, t_x, bert_dim), np.float32),
        "en_bert": np.zeros((b, t_x, bert_dim), np.float32),
        "spec": np.zeros((b, t_y, spec_ch), np.float32),
        "spec_lengths": np.zeros((b,), np.int32),
        "wave": np.zeros((b, n_samples), np.float32),
        "sid": np.zeros((b,), np.int32),
    }
    for i, it in enumerate(items):
        t = min(len(it["phones"]), t_x)
        out["x"][i, :t] = it["phones"][:t]
        out["x_lengths"][i] = t
        out["tone"][i, :t] = it["tones"][:t]
        out["language"][i, :t] = it["lang"][:t]
        out["bert"][i, :t] = it["bert"][:t]
        out["ja_bert"][i, :t] = it["ja_bert"][:t]
        out["en_bert"][i, :t] = it["en_bert"][:t]
        f = min(it["spec"].shape[0], t_y)
        out["spec"][i, :f] = it["spec"][:f]
        out["spec_lengths"][i] = f
        n = min(len(it["wave"]), f * hop_length)
        out["wave"][i, :n] = it["wave"][:n]
        out["sid"][i] = it["sid"]
    return out
