"""Utterance-level emotion feature extractors for old-version checkpoints.

V2.1 conditions on a 1024-d wav2vec2 emotion embedding — mean-pooled hidden
states of `wav2vec2-large-robust-12-ft-emotion-msp-dim`
(oldVersion/V210/emo_gen.py:36-107). V2.2 conditions on a 512-d CLAP
(`clap-htsat-fused`) audio or text-prompt feature
(oldVersion/V220/clap_wrapper.py:12-50).

Both run host-side through HF transformers (torch CPU is fine — these are
one-vector-per-utterance, not hot-path). Model weights must exist locally
under `model_dir` (the reference keeps them in ./emotional/); extraction is
gated with a clear error when they don't, and engines fall back to
codebook-index-0 / zero features so old checkpoints still synthesize.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "Wav2Vec2EmotionExtractor",
    "ClapFeatureExtractor",
    "default_emotion_extractor",
]

_EMO_DIR = os.environ.get("BERT_VITS2_EMOTIONAL_DIR", "emotional")


def _load_wav(path_or_array, sr: int):
    if isinstance(path_or_array, np.ndarray):
        return path_or_array.astype(np.float32)
    from scipy.signal import resample_poly

    from bert_vits2_tpu_torch.data.dataset import load_wav

    wave, file_sr = load_wav(str(path_or_array))
    if wave.ndim > 1:
        wave = wave.mean(axis=-1)
    if file_sr != sr:
        from math import gcd

        g = gcd(int(file_sr), sr)
        wave = resample_poly(wave, sr // g, int(file_sr) // g)
    return wave.astype(np.float32)


class Wav2Vec2EmotionExtractor:
    """V2.1 emotion vectors: mean-pooled wav2vec2 hidden states [1024].

    Ref: oldVersion/V210/emo_gen.py process_func(embeddings=True).
    """

    def __init__(self, model_dir: str | None = None, device: str = "cpu"):
        self.model_dir = model_dir or os.path.join(
            _EMO_DIR, "wav2vec2-large-robust-12-ft-emotion-msp-dim"
        )
        self.device = device
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        if not os.path.isdir(self.model_dir):
            raise RuntimeError(
                f"wav2vec2 emotion model not found at {self.model_dir}; "
                "download audeering/wav2vec2-large-robust-12-ft-emotion-msp-dim "
                "there (or set BERT_VITS2_EMOTIONAL_DIR), or pass an integer "
                "emotion codebook index instead of reference audio"
            )
        from transformers import Wav2Vec2Model, Wav2Vec2Processor

        self._processor = Wav2Vec2Processor.from_pretrained(self.model_dir)
        self._model = Wav2Vec2Model.from_pretrained(self.model_dir).to(self.device)
        self._model.eval()

    def __call__(self, reference_audio=None, prompt=None) -> np.ndarray:
        import torch

        self._load()
        wave = _load_wav(reference_audio, 16000)
        inputs = self._processor(wave, sampling_rate=16000)["input_values"][0]
        with torch.no_grad():
            hidden = self._model(
                torch.from_numpy(np.asarray(inputs))[None].to(self.device)
            )[0]
        return hidden.mean(dim=1)[0].cpu().numpy().astype(np.float32)


class ClapFeatureExtractor:
    """V2.2 emotion features: CLAP audio (48 kHz) or text-prompt vector [512].

    Ref: oldVersion/V220/clap_wrapper.py:12-50.
    """

    def __init__(self, model_dir: str | None = None, device: str = "cpu"):
        self.model_dir = model_dir or os.path.join(_EMO_DIR, "clap-htsat-fused")
        self.device = device
        self._model = None
        self._processor = None

    def _load(self):
        if self._model is not None:
            return
        if not os.path.isdir(self.model_dir) or not any(
            f.endswith((".bin", ".safetensors"))
            for f in os.listdir(self.model_dir)
        ):
            raise RuntimeError(
                f"CLAP model weights not found at {self.model_dir}; download "
                "laion/clap-htsat-fused there (or set BERT_VITS2_EMOTIONAL_DIR), "
                "or omit emotion/reference_audio to use zero features"
            )
        from transformers import ClapModel, ClapProcessor

        self._processor = ClapProcessor.from_pretrained(self.model_dir)
        self._model = ClapModel.from_pretrained(self.model_dir).to(self.device)
        self._model.eval()

    def __call__(self, reference_audio=None, prompt=None) -> np.ndarray:
        import torch

        self._load()
        with torch.no_grad():
            if reference_audio is not None:
                wave = _load_wav(reference_audio, 48000)
                inputs = self._processor(
                    audios=wave, return_tensors="pt", sampling_rate=48000
                ).to(self.device)
                emb = self._model.get_audio_features(**inputs)
            else:
                inputs = self._processor(text=prompt, return_tensors="pt").to(
                    self.device
                )
                emb = self._model.get_text_features(**inputs)
        return emb[0].cpu().numpy().astype(np.float32)


def default_emotion_extractor(mode: str):
    if mode == "vq210":
        return Wav2Vec2EmotionExtractor()
    if mode == "clap220":
        return ClapFeatureExtractor()
    raise ValueError(f"no emotion extractor for mode {mode!r}")
