"""Filelist dataset (reference: data_utils.py:16-182 TextAudioSpeakerLoader).

Counterpart of `bert_vits2_tpu/data/dataset.py`. Rows:
`path|spk|lang|text|phones|tones|word2ph` from preprocess_text. Per-item
loading is host-side numpy: wav -> float32, the linear spectrogram by the
framed DFT of `compute_spec` (cached as .spec.npy, the JAX package's cache
names), cached BERT features (.bert.npy, with .bert.pt import fallback).
Inactive languages get N(0,1) placeholders, noise and not zeros, to match
the reference's training distribution (data_utils.py:159-168).

`load_collated_batch` is the JAX package's fast batch path: it reads the
caches straight into the padded batch, through the native thread-pool
loader (`native/`) when one is given and with numpy otherwise, and the
train step draws the inactive languages' placeholders (`train/step.py`
`expand_bert`).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Sequence

import numpy as np

from bert_vits2_tpu_torch.text import cleaned_text_to_sequence
from bert_vits2_tpu_torch.text.symbols import LANGUAGE_ID_MAP

_BERT_DIM = 1024
_LANG_ORDER = ("ZH", "JP", "EN")


@dataclasses.dataclass
class Utterance:
    audio_path: str
    speaker: str
    language: str
    text: str
    phones: list
    tones: list
    word2ph: list
    # estimated spec frames (from file size, before any audio IO) for bucketing
    est_frames: int = 0


def _intersperse(lst: list, item: int) -> list:
    out = [item] * (len(lst) * 2 + 1)
    out[1::2] = lst
    return out


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """16/32-bit PCM or float wav -> float32 in [-1, 1] (scipy, like
    data_utils.py:99-107 which divides by 32768)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, sr


def hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann, matching torch.hann_window(win_length)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def compute_spec(audio: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Linear magnitude spectrogram [frames, n_fft//2+1], numpy: reflect pad
    (n_fft-hop)/2, center=False, periodic Hann, sqrt(re^2+im^2+1e-6) (the
    JAX package's `compute_spec`, ops/stft's spectrogram)."""
    pad = (n_fft - hop) // 2
    y = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * hann_window_periodic(win)
    fft = np.fft.rfft(frames, n=n_fft, axis=1)
    return np.sqrt(fft.real**2 + fft.imag**2 + 1e-6).astype(np.float32)


class FilelistDataset:
    """Indexable dataset over a `.list` filelist.

    __getitem__ returns a dict of numpy arrays:
      phones/tones/lang [t], bert/ja_bert/en_bert [t, bert_dim],
      spec [frames, n_fft//2+1], wave [samples], sid scalar.
    """

    def __init__(
        self,
        filelist: str,
        spk2id: dict,
        sampling_rate: int = 44100,
        filter_length: int = 2048,
        hop_length: int = 512,
        win_length: int = 2048,
        add_blank: bool = True,
        min_text_len: int = 1,
        max_text_len: int = 384,
        use_cache: bool = True,
        rng_seed: int = 1234,
        bert_dim: int = _BERT_DIM,
    ):
        self.bert_dim = bert_dim
        self.spk2id = spk2id
        self.sampling_rate = sampling_rate
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.add_blank = add_blank
        self.use_cache = use_cache
        self.rng_seed = rng_seed

        self.items: list[Utterance] = []
        skipped = 0
        with open(filelist, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split("|")
                if len(parts) != 7:
                    skipped += 1
                    continue
                path, spk, lang, text, phones, tones, word2ph = parts
                phones = phones.split(" ")
                if not (min_text_len <= len(phones) <= max_text_len) or not os.path.isfile(path):
                    skipped += 1
                    continue
                self.items.append(
                    Utterance(
                        audio_path=path,
                        speaker=spk,
                        language=lang,
                        text=text,
                        phones=phones,
                        tones=[int(t) for t in tones.split(" ")],
                        word2ph=[int(w) for w in word2ph.split(" ")],
                        est_frames=os.path.getsize(path) // (2 * hop_length),
                    )
                )
        self.skipped = skipped

    def __len__(self) -> int:
        return len(self.items)

    def lengths(self) -> list[int]:
        """Estimated spec-frame lengths for bucketing (data_utils.py:60)."""
        return [u.est_frames for u in self.items]

    # ---- caching ----

    def _spec_path(self, audio_path: str) -> str:
        return audio_path.replace(".wav", ".spec.npy")

    def _bert_path(self, audio_path: str) -> str:
        return audio_path.replace(".wav", ".bert.npy")

    def _load_audio(self, u: Utterance) -> np.ndarray:
        audio, sr = load_wav(u.audio_path)
        if sr != self.sampling_rate:
            raise ValueError(f"{u.audio_path}: {sr} != {self.sampling_rate} (resample first)")
        return audio

    def _load_spec(self, audio_path: str, audio: np.ndarray) -> np.ndarray:
        cache = self._spec_path(audio_path)
        if self.use_cache and os.path.isfile(cache):
            return np.load(cache)
        spec = compute_spec(audio, self.filter_length, self.hop_length, self.win_length)
        if self.use_cache:
            try:
                np.save(cache, spec)
            except OSError:
                pass  # a read-only corpus: recompute next time
        return spec

    def _load_bert(self, u: Utterance, n_phones: int) -> np.ndarray:
        """[t, bert_dim] phone-level BERT features for the active language."""
        cache = self._bert_path(u.audio_path)
        if os.path.isfile(cache):
            bert = np.load(cache)
        else:
            pt = u.audio_path.replace(".wav", ".bert.pt")
            if not os.path.isfile(pt):
                raise FileNotFoundError(
                    f"no cached BERT features for {u.audio_path} "
                    "(run tools/bert_gen.py first)"
                )
            import torch

            bert = torch.load(pt, map_location="cpu", weights_only=True).float().numpy()
            if self.use_cache:
                try:
                    np.save(cache, bert.astype(np.float32))
                except OSError:
                    pass
        if bert.shape[0] == self.bert_dim and bert.shape[0] != n_phones:
            # reference layout [1024, t]
            bert = bert.T
        if bert.shape[0] != n_phones:
            raise ValueError(f"{cache}: BERT features {bert.shape} for {n_phones} phones")
        return bert.astype(np.float32)

    def _sequences(self, u: Utterance) -> tuple[list, list, list]:
        phones, tones, langs = cleaned_text_to_sequence(u.phones, u.tones, u.language)
        if self.add_blank:
            phones = _intersperse(phones, 0)
            tones = _intersperse(tones, 0)
            langs = _intersperse(langs, 0)
        return phones, tones, langs

    @functools.cached_property
    def text_lengths(self) -> list[int]:
        """Each item's text length after the blanks (its x_lengths in a
        batch), computed once."""
        return [len(self._sequences(u)[0]) for u in self.items]

    def _sid(self, u: Utterance) -> int:
        return self.spk2id[u.speaker] if isinstance(self.spk2id, dict) else int(u.speaker)

    def __getitem__(self, idx: int) -> dict:
        u = self.items[idx]
        phones, tones, langs = self._sequences(u)
        audio = self._load_audio(u)
        spec = self._load_spec(u.audio_path, audio)

        t = len(phones)
        bert = self._load_bert(u, t)
        # inactive languages: unit Gaussian noise, seeded per utterance for
        # reproducibility (reference uses fresh randn each epoch)
        noise_rng = np.random.default_rng((self.rng_seed, idx))
        placeholders = {
            lang: noise_rng.normal(size=(t, self.bert_dim)).astype(np.float32)
            for lang in _LANG_ORDER
            if lang != u.language
        }
        feats = {lang: placeholders.get(lang) for lang in _LANG_ORDER}
        feats[u.language] = bert
        return {
            "phones": np.asarray(phones, np.int32),
            "tones": np.asarray(tones, np.int32),
            "lang": np.asarray(langs, np.int32),
            "bert": feats["ZH"],
            "ja_bert": feats["JP"],
            "en_bert": feats["EN"],
            "spec": spec,
            "wave": audio,
            "sid": np.int32(self._sid(u)),
        }


def load_collated_batch(
    ds: FilelistDataset,
    ids: Sequence[int],
    max_frames: int,
    text_pad_multiple: int = 32,
    loader=None,
    max_text: int | None = None,
) -> dict:
    """Collate a batch straight from the caches into fixed-shape buffers.

    Unlike the itemwise path (__getitem__ + collate.collate_batch):

    - with a `loader` (`native.BatchLoader`), the spec and BERT caches and
      the wavs are read by its thread pool straight into the padded batch
      rows, outside the interpreter lock; an item whose file it could not
      read (or whose BERT layout does not match) is read again itemwise;
    - the inactive-language BERT placeholders are not drawn here: the batch
      carries `bert` = the ACTIVE language's features plus `utt_lang` [b],
      and the train step draws the N(0,1) placeholders on the device
      (train/step.py `expand_bert`). The reference draws two [1024, t]
      noise tensors per item per epoch on the host (data_utils.py:159-168)
      and ships 3x the bytes to the device; the placeholders are pure
      noise, so the semantics are the same.

    The text axis fits `max_text` tokens (default the batch's longest),
    rounded up to `text_pad_multiple`: ranks of one global batch pass its
    longest, so that their arrays have one shape.

    Returns the train-step batch dict with keys: x, x_lengths, tone,
    language, bert [b, t, bert_dim] (active), utt_lang [b], spec,
    spec_lengths, wave, sid.
    """
    b = len(ids)
    utts = [ds.items[i] for i in ids]
    seqs = [ds._sequences(u) for u in utts]
    if max_text is None:
        max_text = max(len(s[0]) for s in seqs)
    t_x = ((max_text + text_pad_multiple - 1) // text_pad_multiple) * text_pad_multiple
    t_y = max_frames
    hop = ds.hop_length
    n_samples = t_y * hop
    spec_ch = ds.filter_length // 2 + 1

    out = {
        "x": np.zeros((b, t_x), np.int32),
        "x_lengths": np.zeros((b,), np.int32),
        "tone": np.zeros((b, t_x), np.int32),
        "language": np.zeros((b, t_x), np.int32),
        "bert": np.zeros((b, t_x, ds.bert_dim), np.float32),
        "utt_lang": np.zeros((b,), np.int32),
        "spec": np.zeros((b, t_y, spec_ch), np.float32),
        "spec_lengths": np.zeros((b,), np.int32),
        "wave": np.zeros((b, n_samples), np.float32),
        "sid": np.zeros((b,), np.int32),
    }
    for i, (u, (phones, tones, langs)) in enumerate(zip(utts, seqs)):
        t = min(len(phones), t_x)
        out["x"][i, :t] = phones[:t]
        out["x_lengths"][i] = t
        out["tone"][i, :t] = tones[:t]
        out["language"][i, :t] = langs[:t]
        out["utt_lang"][i] = LANGUAGE_ID_MAP[u.language]
        out["sid"][i] = ds._sid(u)

    spec_paths = [ds._spec_path(u.audio_path) for u in utts]
    bert_paths = [ds._bert_path(u.audio_path) for u in utts]
    wav_paths = [u.audio_path for u in utts]

    spec_rows = wave_lens = bert_rows = bert_cols = None
    if loader is not None:
        if all(os.path.isfile(p) for p in spec_paths):
            spec_rows, _ = loader.load_npy_into(spec_paths, out["spec"])
        wave_lens, wave_srs = loader.load_wav_into(wav_paths, out["wave"])
        if all(os.path.isfile(p) for p in bert_paths):
            bert_rows, bert_cols = loader.load_npy_into(bert_paths, out["bert"])

    for i, u in enumerate(utts):
        if spec_rows is not None and spec_rows[i] > 0:
            out["spec_lengths"][i] = min(int(spec_rows[i]), t_y)
        else:
            # the full audio: _load_spec caches, and a spec computed from
            # the batch-truncated wave row would poison the cache
            spec = ds._load_spec(u.audio_path, ds._load_audio(u))
            f = min(spec.shape[0], t_y)
            out["spec"][i, :f] = spec[:f]
            out["spec_lengths"][i] = f

        # the wave, truncated to whole spec frames like collate.collate_batch
        if wave_lens is None or wave_lens[i] < 0:
            audio = ds._load_audio(u)
            n = min(len(audio), n_samples)
            out["wave"][i, :n] = audio[:n]
        elif int(wave_srs[i]) != ds.sampling_rate:
            raise ValueError(f"{u.audio_path}: {int(wave_srs[i])} != "
                             f"{ds.sampling_rate} (resample first)")
        out["wave"][i, int(out["spec_lengths"][i]) * hop:] = 0.0

        # the active language's BERT features
        t = int(out["x_lengths"][i])
        if not (bert_rows is not None and bert_rows[i] == t
                and bert_cols[i] == ds.bert_dim):
            if bert_rows is not None and bert_rows[i] > 0:
                out["bert"][i] = 0.0  # the loaded layout did not match: reload
            out["bert"][i, :t] = ds._load_bert(u, t)[:t]
    return out
