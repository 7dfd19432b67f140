"""Precompute phone-level BERT feature caches (reference: bert_gen.py:12-81).

Counterpart of `bert_vits2_tpu/preprocess/bert_gen.py`. Writes
`<wav>.bert.npy` ([n_phones_with_blanks, 1024] float32) for every filelist
row with the port's per-language encoders (`text/bert.py`
`AutoBertExtractor` on `--device`, the card by default; the local weights
of every language are required). With --random, writes seeded N(0,1)
features instead: for pipelines that train without BERT, or to try the
pipeline without the weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _double_word2ph(word2ph: list[int]) -> list[int]:
    out = [w * 2 for w in word2ph]
    out[0] += 1
    return out


def bert_gen(
    filelist: str,
    extractor=None,
    add_blank: bool = True,
    overwrite: bool = False,
) -> int:
    from bert_vits2_tpu_torch.text.bert import RandomBertExtractor

    extractor = extractor or RandomBertExtractor()
    n = 0
    with open(filelist, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, _spk, language, text, phones, _tones, word2ph = line.split("|")
            out = utt.replace(".wav", ".bert.npy")
            if os.path.isfile(out) and not overwrite:
                continue
            w2p = [int(w) for w in word2ph.split(" ")]
            if add_blank:
                w2p = _double_word2ph(w2p)
            feats = extractor(text, w2p, language)
            n_ph = len(phones.split(" ")) * (2 if add_blank else 1) + (
                1 if add_blank else 0
            )
            assert feats.shape[0] == n_ph, (feats.shape, n_ph, utt)
            np.save(out, feats.astype(np.float32))
            n += 1
    return n


def main():
    ap = argparse.ArgumentParser(description="Precompute .bert.npy caches")
    ap.add_argument("-c", "--config", required=True, help="config.json")
    ap.add_argument("--random", action="store_true",
                    help="seeded noise features (no BERT weights needed)")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the BERT encoders run (cuda, cpu)")
    args = ap.parse_args()

    from bert_vits2_tpu_torch.compat.hparams import get_hparams_from_file

    hps = get_hparams_from_file(args.config)
    if args.random:
        extractor = None
    else:
        from bert_vits2_tpu_torch.device import resolve_device
        from bert_vits2_tpu_torch.text.bert import AutoBertExtractor

        extractor = AutoBertExtractor(allow_noise=False,
                                      device=resolve_device(args.device))
    total = 0
    for filelist in (hps.data.training_files, hps.data.validation_files):
        if filelist and os.path.isfile(filelist):
            total += bert_gen(
                filelist,
                extractor,
                add_blank=hps.data.get("add_blank", True),
                overwrite=args.overwrite,
            )
    print(f"bert_gen wrote {total} feature files")


if __name__ == "__main__":
    main()
