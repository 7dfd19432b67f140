"""Resample a corpus to 44.1 kHz mono wav (reference: resample.py:12-75).

Counterpart of `bert_vits2_tpu/preprocess/resample.py`. librosa is not
installed; scipy.signal.resample_poly gives the polyphase result that the
reference gets from librosa's default (soxr 'HQ' and polyphase differ at
the -120 dB level, far below what training sees). Output: PCM16 mono.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from bert_vits2_tpu_torch.preprocess._pool import map_jobs


def resample_file(in_path: str, out_path: str, sr_out: int = 44100) -> None:
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from bert_vits2_tpu_torch.data.dataset import load_wav

    audio, sr_in = load_wav(in_path)
    if sr_in != sr_out:
        g = math.gcd(sr_in, sr_out)
        audio = resample_poly(audio, sr_out // g, sr_in // g)
    audio = np.clip(audio, -1.0, 1.0)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    wavfile.write(out_path, sr_out, (audio * 32767.0).astype(np.int16))


def _job(args):
    in_path, out_path, sr = args
    try:
        resample_file(in_path, out_path, sr)
        return None
    except Exception as e:  # noqa: BLE001 - report per file, keep going
        return f"{in_path}: {e}"


def resample_jobs(in_dir: str, out_dir: str, sr: int) -> list:
    """(in, out, sr) for every .wav under in_dir, at the same relative path
    under out_dir."""
    jobs = []
    for dirpath, _dirs, files in os.walk(in_dir):
        for f in files:
            if f.lower().endswith(".wav"):
                rel = os.path.relpath(os.path.join(dirpath, f), in_dir)
                jobs.append((os.path.join(in_dir, rel), os.path.join(out_dir, rel), sr))
    return jobs


def main():
    ap = argparse.ArgumentParser(description="Resample corpus to 44.1k mono")
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--in-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--processes", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()

    jobs = resample_jobs(args.in_dir, args.out_dir, args.sr)
    errors = [e for e in map_jobs(_job, jobs, args.processes) if e]
    print(f"resampled {len(jobs) - len(errors)}/{len(jobs)} files")
    for e in errors:
        print("ERROR", e)


if __name__ == "__main__":
    main()
