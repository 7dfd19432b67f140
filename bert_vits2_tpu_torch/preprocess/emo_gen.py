"""Emotion / CLAP feature cache generation for V2.1 / V2.2 datasets
(reference: oldVersion/V210/emo_gen.py:110-180, oldVersion/V220/clap_gen.py).

Writes `<wav>.emo.npy` next to each audio file: a 1024-d wav2vec2 emotion
embedding (--mode wav2vec2, V2.1) or a 512-d CLAP audio feature
(--mode clap, V2.2). Sequential single-process on purpose — the extractor
holds one HF model; per-utterance cost dwarfs fork overhead.

Counterpart of `bert_vits2_tpu/preprocess/emo_gen.py` with the port's
extractors (`text/emotion.py`), run on `device`: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def emo_gen(filelist: str, mode: str = "wav2vec2", device: str = "cuda"):
    from bert_vits2_tpu_torch.device import resolve_device
    from bert_vits2_tpu_torch.text.emotion import (
        ClapFeatureExtractor,
        Wav2Vec2EmotionExtractor,
    )

    device = str(resolve_device(device))

    extractor = (
        Wav2Vec2EmotionExtractor(device=device)
        if mode == "wav2vec2"
        else ClapFeatureExtractor(device=device)
    )
    paths = []
    with open(filelist, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                paths.append(line.split("|")[0])
    done = errors = 0
    for p in paths:
        out = p.replace(".wav", ".emo.npy")
        if os.path.isfile(out) or not os.path.isfile(p):
            continue
        try:
            np.save(out, extractor(reference_audio=p))
            done += 1
        except Exception as e:  # noqa: BLE001
            errors += 1
            print("ERROR", p, e)
    print(f"cached {done} emotion features ({errors} errors)")


def main():
    ap = argparse.ArgumentParser(description="Precompute .emo.npy caches")
    ap.add_argument("-c", "--config", required=True, help="config.json")
    ap.add_argument("--mode", choices=("wav2vec2", "clap"), default="wav2vec2",
                    help="wav2vec2 = V2.1 emotion vectors; clap = V2.2 features")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from bert_vits2_tpu_torch.compat.hparams import get_hparams_from_file

    hps = get_hparams_from_file(args.config)
    for filelist in (hps.data.training_files, hps.data.validation_files):
        emo_gen(filelist, mode=args.mode, device=args.device)


if __name__ == "__main__":
    main()
