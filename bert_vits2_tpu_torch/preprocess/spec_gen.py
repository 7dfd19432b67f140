"""Parallel spectrogram cache generation (reference: spec_gen.py:8-88).

Counterpart of `bert_vits2_tpu/preprocess/spec_gen.py`: writes
`<wav>.spec.npy` ([frames, n_fft // 2 + 1] float32, `data/dataset.py`
`compute_spec`) next to each audio file, so training never computes STFTs
in the input pipeline.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bert_vits2_tpu_torch.preprocess._pool import map_jobs


def _job(args):
    path, n_fft, hop, win = args
    try:
        out = path.replace(".wav", ".spec.npy")
        if os.path.isfile(out):
            return None
        from bert_vits2_tpu_torch.data.dataset import compute_spec, load_wav

        audio, _sr = load_wav(path)
        np.save(out, compute_spec(audio, n_fft, hop, win))
        return None
    except Exception as e:  # noqa: BLE001
        return f"{path}: {e}"


def spec_gen(filelist: str, n_fft: int, hop: int, win: int, processes: int = 8):
    paths = []
    with open(filelist, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                paths.append(line.split("|")[0])
    jobs = [(p, n_fft, hop, win) for p in paths if os.path.isfile(p)]
    errors = [e for e in map_jobs(_job, jobs, processes) if e]
    print(f"cached {len(jobs) - len(errors)}/{len(jobs)} spectrograms")
    for e in errors:
        print("ERROR", e)


def main():
    ap = argparse.ArgumentParser(description="Precompute .spec.npy caches")
    ap.add_argument("-c", "--config", required=True, help="config.json")
    ap.add_argument("--processes", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()
    from bert_vits2_tpu_torch.compat.hparams import get_hparams_from_file

    hps = get_hparams_from_file(args.config)
    for filelist in (hps.data.training_files, hps.data.validation_files):
        if filelist and os.path.isfile(filelist):
            spec_gen(filelist, hps.data.filter_length, hps.data.hop_length,
                     hps.data.win_length, args.processes)


if __name__ == "__main__":
    main()
