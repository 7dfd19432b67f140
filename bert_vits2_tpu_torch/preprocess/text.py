"""Transcript -> cleaned phoneme filelists + config.json update
(reference: preprocess_text.py:34-137).

Counterpart of `bert_vits2_tpu/preprocess/text.py`, with the port's g2p
(`text.clean_text`).

Input rows: `path|speaker|language|text`. Output rows append
`|phones|tones|word2ph`. Dedups audio, drops missing files, splits
val_per_lang utterances per language (capped at max_val_total), rewrites
config.json spk2id / n_speakers / training_files / validation_files /
version.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from collections import defaultdict

LATEST_VERSION = "2.3"


def clean_transcripts(transcription_path: str, cleaned_path: str) -> int:
    from bert_vits2_tpu_torch.text import clean_text

    n = 0
    with open(cleaned_path, "w", encoding="utf-8") as out, open(
        transcription_path, encoding="utf-8"
    ) as src:
        for line in src:
            line = line.strip()
            if not line:
                continue
            try:
                utt, spk, language, text = line.split("|")
                norm_text, phones, tones, word2ph = clean_text(text, language)
                out.write(
                    "|".join(
                        [
                            utt,
                            spk,
                            language,
                            norm_text,
                            " ".join(phones),
                            " ".join(str(i) for i in tones),
                            " ".join(str(i) for i in word2ph),
                        ]
                    )
                    + "\n"
                )
                n += 1
            except Exception as e:  # noqa: BLE001 - report per-line, keep going
                print(f"error cleaning {line!r}: {e}")
    return n


def preprocess_text(
    transcription_path: str,
    cleaned_path: str | None = None,
    train_path: str | None = None,
    val_path: str | None = None,
    config_path: str | None = None,
    val_per_lang: int = 4,
    max_val_total: int = 12,
    clean: bool = True,
    seed: int = 42,
) -> dict:
    """Returns the spk2id map. File layout mirrors the reference CLI."""
    base = os.path.dirname(transcription_path)
    cleaned_path = cleaned_path or transcription_path + ".cleaned"
    train_path = train_path or os.path.join(base, "train.list")
    val_path = val_path or os.path.join(base, "val.list")

    if clean:
        clean_transcripts(transcription_path, cleaned_path)

    lang_utt_map = defaultdict(list)
    spk_id_map: dict[str, int] = {}
    seen, n_dup, n_missing = set(), 0, 0
    with open(cleaned_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            utt, spk, language, _text, _ph, _tn, _w2p = line.strip().split("|")
            if utt in seen:
                n_dup += 1
                continue
            if not os.path.isfile(utt):
                n_missing += 1
                continue
            seen.add(utt)
            lang_utt_map[language].append(line)
            if spk not in spk_id_map:
                spk_id_map[spk] = len(spk_id_map)
    print(f"dedup dropped {n_dup}, missing audio {n_missing}")

    rng = random.Random(seed)
    train_list, val_list = [], []
    for _lang, utts in lang_utt_map.items():
        rng.shuffle(utts)
        val_list += utts[:val_per_lang]
        train_list += utts[val_per_lang:]
    rng.shuffle(val_list)
    if len(val_list) > max_val_total:
        train_list += val_list[max_val_total:]
        val_list = val_list[:max_val_total]

    with open(train_path, "w", encoding="utf-8") as f:
        f.writelines(train_list)
    with open(val_path, "w", encoding="utf-8") as f:
        f.writelines(val_list)

    if config_path and os.path.isfile(config_path):
        with open(config_path, encoding="utf-8") as f:
            cfg = json.load(f)
        cfg.setdefault("data", {})
        cfg["data"]["spk2id"] = spk_id_map
        cfg["data"]["n_speakers"] = len(spk_id_map)
        cfg["data"]["training_files"] = train_path.replace("\\", "/")
        cfg["data"]["validation_files"] = val_path.replace("\\", "/")
        cfg["version"] = LATEST_VERSION
        with open(config_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f, indent=2, ensure_ascii=False)
    print(f"wrote {len(train_list)} train / {len(val_list)} val rows")
    return spk_id_map


def main():
    ap = argparse.ArgumentParser(description="Clean transcripts, split train/val")
    ap.add_argument("--transcription-path", required=True)
    ap.add_argument("--cleaned-path", default=None)
    ap.add_argument("--train-path", default=None)
    ap.add_argument("--val-path", default=None)
    ap.add_argument("--config-path", default=None)
    ap.add_argument("--val-per-lang", type=int, default=4)
    ap.add_argument("--max-val-total", type=int, default=12)
    ap.add_argument("--no-clean", action="store_true")
    args = ap.parse_args()
    preprocess_text(
        args.transcription_path,
        args.cleaned_path,
        args.train_path,
        args.val_path,
        args.config_path,
        args.val_per_lang,
        args.max_val_total,
        clean=not args.no_clean,
    )


if __name__ == "__main__":
    main()
