"""Batched, statically shaped TTS engine (reference: infer.py:107-437).

Counterpart of `bert_vits2_tpu/infer/api.py`:

- the host half: `get_text` (g2p, blank intersperse, BERT at phone level,
  N(0,1) features for the two inactive languages, drawn exactly as the JAX
  engine draws them) and `TTSEngine.prepare`, with the reference's 3/2-token
  boundary trims (`skip_start` / `skip_end`) and mixed-language segments;
- the device half: requests prepared on the host (`PreparedRequest`) are
  padded to a shared text bucket and frame cap and synthesized in one
  batched call. The rules that fix the shapes are the JAX engine's, so
  `y_len` and the caps match it: text buckets (`_bucket`), the worst-case
  frame cap (`_frame_cap`), power-of-two batch padding (`_pad_idx`) and a
  cap taken from the predicted durations (`run_prepared`);
- the entry points `infer`, `infer_multilang`, `infer_batch` (piles above
  `max_batch` go to the length-sorted `run_packed`) and `warmup`.

Every version family of `compat/versions.py`: the engine's `version_spec`
picks the symbol table, tone offsets, languages and inactive-language fill
of `get_text`, and the V2.1/V2.2 families take an emotion input per
request (`_resolve_emotion`: a codebook index, a zero CLAP feature, or an
extractor's vector from reference audio or a CLAP text prompt). The JAX
engine's `pack_requests` (its two-buffer device pool, which
its `predict_frames` and `run_packed` address by row) is not ported: here
the request tensors are handed to the device directly for each call.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.text import clean_text, cleaned_text_to_sequence
from bert_vits2_tpu_torch.text.bert import BERT_DIM, AutoBertExtractor

_LANGS = ("ZH", "JP", "EN")


@functools.lru_cache(maxsize=1)
def default_bert_extractor() -> AutoBertExtractor:
    """Shared default extractor for direct get_text callers: the encoder
    caches loaded weights per instance, so callers must share one instance
    or reload the checkpoint every call (TTSEngine holds its own)."""
    return AutoBertExtractor()


def _intersperse(lst, item=0):
    out = [item] * (len(lst) * 2 + 1)
    out[1::2] = lst
    return out


def get_text(
    text: str,
    language: str,
    bert_extractor=None,
    add_blank: bool = True,
    style_text: str | None = None,
    style_weight: float = 0.7,
    noise_seed: int = 0,
    spec=None,
):
    """text -> (phones, tones, lang_ids [t] int32, bert/ja_bert/en_bert
    [t, dim] float32).

    Ref: infer.py:107-149 (g2p, intersperse, BERT at phone level, randn
    placeholders for the two inactive languages, here from
    `np.random.default_rng((noise_seed, t))`). `spec` (a
    `compat.versions.VersionSpec`) switches to an old version family: its
    symbol table and tone offsets, its languages (another raises
    ValueError), zero fills instead of randn (oldVersion/V200/__init__.py:
    29-37) and its ja_bert width (768 on 1.1: the active feature is cut).
    """
    bert_extractor = bert_extractor or default_bert_extractor()
    norm_text, phones_s, tones, word2ph = clean_text(text, language)
    if spec is not None and spec.family != "2.3":
        if language not in spec.languages:
            raise ValueError(
                f"version {spec.family} checkpoints only synthesize "
                f"{spec.languages}, not {language}")
        phones, tones, lang_ids = spec.cleaned_text_to_sequence(
            phones_s, tones, language)
    else:
        phones, tones, lang_ids = cleaned_text_to_sequence(phones_s, tones, language)
    if add_blank:
        phones = _intersperse(phones)
        tones = _intersperse(tones)
        lang_ids = _intersperse(lang_ids)
        word2ph = [w * 2 for w in word2ph]
        word2ph[0] += 1

    t = len(phones)
    bert = bert_extractor(norm_text, word2ph, language,
                          style_text=style_text, style_weight=style_weight)
    assert bert.shape == (t, BERT_DIM), (bert.shape, t)
    dims = {"ZH": BERT_DIM, "JP": BERT_DIM, "EN": BERT_DIM}
    if spec is not None:
        dims["JP"] = spec.ja_bert_dim
    if spec is None or spec.inactive_fill == "randn":
        rng = np.random.default_rng((noise_seed, t))
        feats = {lang: rng.normal(size=(t, dims[lang])).astype(np.float32)
                 for lang in _LANGS if lang != language}
    else:
        feats = {lang: np.zeros((t, dims[lang]), np.float32)
                 for lang in _LANGS if lang != language}
    feats[language] = bert.astype(np.float32)[:, :dims[language]]
    return (
        np.asarray(phones, np.int32),
        np.asarray(tones, np.int32),
        np.asarray(lang_ids, np.int32),
        feats["ZH"],
        feats["JP"],
        feats["EN"],
    )


class PreparedRequest(NamedTuple):
    """One host-preprocessed utterance: `inputs` is (phones, tones,
    lang_ids [t], bert, ja_bert, en_bert [t, dim]); `emo` is one emotion
    row ([1] int codebook index or [1, d] float32 vector) for a V2.1/V2.2
    engine, else None; the knobs ride along per request and become [b]
    tensors of the batched call."""

    inputs: tuple
    sid: int
    emo: np.ndarray | None = None
    sdp_ratio: float = 0.2
    noise_scale: float = 0.667
    noise_scale_w: float = 0.8
    length_scale: float = 1.0
    seed: int = 0


class TTSEngine:
    """Holds a Synthesizer on one device and runs batched synthesis.

    spk2id: speaker name -> id (config.json data.spk2id), for string
    speakers; integer speakers pass through. emotion_extractor: the
    V2.1/V2.2 feature extractor for reference audio or a CLAP prompt
    (`text/emotion.py`; the default one for the model's branch is built on
    first use).

    The model's `cfg.infer_compute_dtype` sets the dtype of the flow and
    the decoder in every synthesis call (`run_prepared`, `run_packed`,
    `infer*`, `warmup`); `predict_frames` and the frame caps run in
    float32 either way, so the lengths do not depend on it.

    `stats` counts, across run_prepared calls: frames_capacity (padded batch
    x frame cap), frames_delivered (frames inside real requests' y_len) and
    bytes_h2d (request tensors shipped to the device)."""

    def __init__(self, model: Synthesizer, spk2id: dict | None = None,
                 sampling_rate: int = 44100, bert_extractor=None,
                 text_buckets: Sequence[int] = (32, 64, 128, 256, 384),
                 frames_per_token: int = 6, frame_multiple: int = 64,
                 version_spec=None, emotion_extractor=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spk2id = spk2id or {}
        self.sampling_rate = sampling_rate
        # real per-language BERT on the engine's device when local weights
        # exist; loud-warned noise otherwise
        self.bert_extractor = bert_extractor or AutoBertExtractor(device=self.device)
        self.version_spec = version_spec
        self.emotion_extractor = emotion_extractor
        # the server prepares on its handler threads: one lock builds the
        # default extractor once and loads its weights (text/emotion.py, a
        # pinned copy, loads lazily and holds no lock); the extraction
        # itself runs unlocked
        self._emotion_lock = threading.Lock()
        self.hop_length = model.cfg.hop_length
        self.text_buckets = tuple(sorted(text_buckets))
        self.frames_per_token = frames_per_token
        self.frame_multiple = frame_multiple
        self.stats = {"frames_capacity": 0, "frames_delivered": 0,
                      "bytes_h2d": 0}
        # the flow and decoder in the model's infer_compute_dtype, and K2's
        # weights packed for it, each made once (float32: the modules
        # themselves; bfloat16: copies resolved in float32, then cast)
        with torch.no_grad():
            self.stages = self.model.compute_stages()
        with torch.inference_mode():
            self.mrf_packed = self.model.dec.pack_mrf(self.model.compute_dtype)

    def _resolve_emotion(self, emotion, reference_audio, batch: int):
        """-> the emotion rows for the model, or None for emotion-less versions.

        V2.1 (oldVersion/V210/__init__.py:54-62): reference audio -> the
        wav2vec2 1024-d vector; else an integer codebook index (default 0).
        V2.2 (oldVersion/V220/__init__.py:73-78): reference audio -> the
        CLAP audio feature; a text prompt -> the CLAP text feature; else
        zeros; 512-d."""
        mode = self.model.cfg.emotion
        if mode == "none":
            return None
        use_extractor = reference_audio is not None or (
            mode == "clap220" and isinstance(emotion, str) and emotion)
        if use_extractor:
            if self.emotion_extractor is None:
                with self._emotion_lock:
                    if self.emotion_extractor is None:
                        self.emotion_extractor = self._default_emotion_extractor(mode)
            vec = self.emotion_extractor(reference_audio=reference_audio,
                                         prompt=emotion)
            return np.broadcast_to(np.asarray(vec, np.float32),
                                   (batch, len(vec))).copy()
        if mode == "vq210":
            idx = 0 if emotion in (None, "") else int(float(emotion))
            return np.full((batch,), idx, np.int32)
        return np.zeros((batch, 512), np.float32)

    def _default_emotion_extractor(self, mode: str):
        """The reference's extractor of `mode` on the engine's device, its
        weights loaded before any other thread can call it (the lock is
        held)."""
        from bert_vits2_tpu_torch.text import emotion as emotion_module

        cls = {"vq210": emotion_module.Wav2Vec2EmotionExtractor,
               "clap220": emotion_module.ClapFeatureExtractor}[mode]
        extractor = cls(device=self.device)
        extractor._load()
        return extractor

    # ---- shape bucketing (the JAX engine's rules) ----

    def _bucket(self, t: int) -> int:
        for b in self.text_buckets:
            if t <= b:
                return b
        return ((t + 63) // 64) * 64

    def group_key(self, req: PreparedRequest):
        """Batching key: requests sharing it can ride one call."""
        emo_kind = None if req.emo is None else (req.emo.dtype.str,
                                                  req.emo.shape[1:])
        return (self._bucket(len(req.inputs[0])), emo_kind)

    def _frame_cap(self, t_x: int, length_scale: float) -> int:
        cap = int(t_x * self.frames_per_token * max(length_scale, 1.0))
        m = self.frame_multiple
        return max(m, ((cap + m - 1) // m) * m)

    def _pad_idx(self, idx: list[int]) -> np.ndarray:
        """Pad the batch to a power of two by repeating the last row."""
        n_pad = 1 << max(len(idx) - 1, 0).bit_length()
        return np.asarray(list(idx) + [idx[-1]] * (n_pad - len(idx)), np.int32)

    # ---- batching ----

    def _batch(self, reqs: Sequence[PreparedRequest]) -> dict:
        """Pad requests to their bucket and the power-of-two batch -> the
        model's keyword tensors on the device; `emo` rides as [b] int64
        codebook indices or [b, d] float32 rows."""
        t_x = self._bucket(max(len(r.inputs[0]) for r in reqs))
        rows = [reqs[i] for i in self._pad_idx(list(range(len(reqs))))]
        b = len(rows)
        ints = np.zeros((3, b, t_x), np.int64)
        feats = [np.zeros((b, t_x, np.asarray(reqs[0].inputs[3 + j]).shape[1]),
                          np.float32) for j in range(3)]
        for i, r in enumerate(rows):
            n = len(r.inputs[0])
            for j in range(3):
                ints[j, i, :n] = r.inputs[j]
                feats[j][i, :n] = r.inputs[3 + j]
        host = {
            "x": ints[0], "tone": ints[1], "language": ints[2],
            "x_lengths": np.asarray([len(r.inputs[0]) for r in rows], np.int64),
            "sid": np.asarray([r.sid for r in rows], np.int64),
            "bert": feats[0], "ja_bert": feats[1], "en_bert": feats[2],
        }
        for k in ("noise_scale", "length_scale", "noise_scale_w", "sdp_ratio"):
            host[k] = np.asarray([getattr(r, k) for r in rows], np.float32)
        if reqs[0].emo is not None:
            emo = np.concatenate([np.asarray(r.emo) for r in rows])
            host["emo"] = (emo.astype(np.int64) if np.issubdtype(emo.dtype, np.integer)
                           else emo.astype(np.float32))
        self.stats["bytes_h2d"] += sum(a.nbytes for a in host.values())
        return {k: torch.from_numpy(a).to(self.device) for k, a in host.items()}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _predict(self, batch: dict, seed: int) -> np.ndarray:
        kw = {k: v for k, v in batch.items() if k != "noise_scale"}
        frames = self.model.predict_durations(
            generator=self._generator(seed), **kw)
        return frames.cpu().numpy()

    # ---- public API ----

    @torch.inference_mode()
    def predict_frames(self, reqs: Sequence[PreparedRequest]) -> np.ndarray:
        """Predicted output frames per request [n] from the duration-only
        pass; exact for run_prepared on the same batch (same noise)."""
        self._check_one_kind(reqs)
        return self._predict(self._batch(reqs), reqs[0].seed)[: len(reqs)]

    def _check_one_kind(self, reqs):
        if len({self.group_key(r)[1] for r in reqs}) > 1:
            raise ValueError("requests mix emotion input kinds")

    @torch.inference_mode()
    def run_prepared(self, reqs: Sequence[PreparedRequest],
                     predicted_frames: np.ndarray | None = None,
                     return_waves: bool = True) -> list:
        """Synthesize prepared requests in one batched call -> trimmed
        float32 waveforms in request order (or, with return_waves=False,
        their lengths in samples).

        The frame cap is the predicted maximum rounded up to the frame
        multiple, never above the worst-case tokens x frames_per_token
        bound; pass `predicted_frames` (from predict_frames over the same
        requests) to skip the duration pass."""
        self._check_one_kind(reqs)
        n_req = len(reqs)
        batch = self._batch(reqs)
        t_x = batch["x"].shape[1]
        if predicted_frames is None:
            predicted_frames = self._predict(batch, reqs[0].seed)[:n_req]
        m = self.frame_multiple
        cap = -(-int(max(int(np.max(predicted_frames)), 1)) // m) * m
        max_frames = min(max(cap, m),
                         self._frame_cap(t_x, max(r.length_scale for r in reqs)))
        wave, _, _, y_len = self.model.infer(
            max_frames=max_frames, generator=self._generator(reqs[0].seed),
            mrf_packed=self.mrf_packed, stages=self.stages, **batch)
        y_len = y_len.cpu().numpy()
        n_pad = batch["x"].shape[0]
        self.stats["frames_capacity"] += n_pad * max_frames
        self.stats["frames_delivered"] += int(
            np.minimum(y_len[:n_req], max_frames).sum())
        lens = [min(int(y_len[i]), max_frames) * self.hop_length
                for i in range(n_req)]
        if not return_waves:
            return lens
        wave = wave[:n_req].cpu().numpy()
        return [wave[i, :lens[i]] for i in range(n_req)]

    def plan_packed(self, frames: np.ndarray, max_batch: int):
        """Length-sorted chunk plan [(rows, frame_cap), ...] for run_packed;
        `frames` are per-request predicted frame counts."""
        order = sorted(range(len(frames)), key=lambda i: -int(frames[i]))
        plan = []
        m = self.frame_multiple
        for lo in range(0, len(order), max_batch):
            rows = order[lo:lo + max_batch]
            cap = -(-int(max(int(frames[rows[0]]), 1)) // m) * m
            plan.append((rows, max(cap, m)))
        return plan

    def run_packed(self, reqs: Sequence[PreparedRequest], max_batch: int = 16,
                   return_waves: bool = True) -> list:
        """Length-aware batched synthesis: predict every request's frames,
        sort by them and cut the pile into <= max_batch chunks, each with its
        own frame cap. Returns waveforms in request order. Each chunk
        re-predicts its own batch, since the SDP noise is positional."""
        self._check_one_kind(reqs)
        frames = self.predict_frames(reqs)
        waves = {}
        for rows, _ in self.plan_packed(frames, max_batch):
            out = self.run_prepared([reqs[i] for i in rows],
                                    return_waves=return_waves)
            waves.update(zip(rows, out))
        return [waves[i] for i in range(len(reqs))]

    # ---- text entry points ----

    @torch.inference_mode()
    def warmup(self, batch_sizes: Sequence[int] = (1, 4, 16),
               buckets: Sequence[int] | None = None,
               length_scale: float = 1.0) -> int:
        """Run the (batch, bucket, worst-case frame cap) grid once, with the
        duration pass, so that cuDNN's algorithm choice and the caching
        allocator settle before serving. Returns the number of grid points.
        run_prepared picks tighter caps from the predicted durations, so a
        cap below the worst case still meets cuDNN afresh the first time."""
        cfg = self.model.cfg
        n = 0
        for t_x in list(buckets or self.text_buckets):
            max_frames = self._frame_cap(t_x, length_scale)
            for b in batch_sizes:
                ints = torch.zeros((b, t_x), dtype=torch.long, device=self.device)
                bert = torch.zeros((b, t_x, cfg.bert_dim), device=self.device)
                ja_bert = torch.zeros((b, t_x, cfg.ja_bert_dim), device=self.device)
                knob = torch.full((b,), 0.5, device=self.device)
                batch = dict(x=ints, tone=ints, language=ints,
                             x_lengths=torch.full((b,), t_x, dtype=torch.long,
                                                  device=self.device),
                             sid=torch.zeros((b,), dtype=torch.long, device=self.device),
                             bert=bert, ja_bert=ja_bert, en_bert=bert,
                             noise_scale=knob, length_scale=knob,
                             noise_scale_w=knob, sdp_ratio=knob)
                if cfg.emotion == "vq210":  # the codebook-index kind
                    batch["emo"] = torch.zeros((b,), dtype=torch.long, device=self.device)
                elif cfg.emotion == "clap220":
                    batch["emo"] = torch.zeros((b, 512), device=self.device)
                self._predict(batch, 0)
                self.model.infer(max_frames=max_frames, generator=self._generator(0),
                                 mrf_packed=self.mrf_packed, stages=self.stages, **batch)
                n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def resolve_speaker(self, speaker) -> int:
        if isinstance(speaker, str):
            return int(self.spk2id[speaker])
        return int(speaker)

    def infer(
        self,
        text: str,
        speaker,
        language: str = "ZH",
        sdp_ratio: float = 0.2,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        style_text: str | None = None,
        style_weight: float = 0.7,
        skip_start: bool = False,
        skip_end: bool = False,
        emotion=None,
        reference_audio=None,
        seed: int = 0,
    ) -> np.ndarray:
        """Synthesize one utterance -> float32 waveform [n_samples].

        Ref: infer.py:151-332 (incl. the 3/2-token boundary trims).
        emotion/reference_audio condition V2.1/V2.2 checkpoints (int codebook
        index or wav path / CLAP text prompt); ignored for other versions."""
        req = self.prepare(
            text, speaker, language=language, sdp_ratio=sdp_ratio,
            noise_scale=noise_scale, noise_scale_w=noise_scale_w,
            length_scale=length_scale, style_text=style_text,
            style_weight=style_weight, skip_start=skip_start,
            skip_end=skip_end, emotion=emotion,
            reference_audio=reference_audio, seed=seed,
        )
        return self.run_prepared([req])[0]

    def prepare(
        self,
        text: str | None,
        speaker,
        language: str = "ZH",
        segments: Sequence[tuple[str, str]] | None = None,
        sdp_ratio: float = 0.2,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        style_text: str | None = None,
        style_weight: float = 0.7,
        skip_start: bool = False,
        skip_end: bool = False,
        emotion=None,
        reference_audio=None,
        seed: int = 0,
    ) -> PreparedRequest:
        """Host-side half of a synthesis call (g2p + BERT + trims + emotion).

        Pass `segments=[(text, lang), ...]` instead of `text` for a
        mixed-language utterance: its per-segment features are concatenated
        into one request, every inner boundary trimmed (ref
        infer.py:335-437). The result runs alone or batched with other
        requests through `run_prepared`."""
        if segments is None:
            inputs = get_text(text, language, self.bert_extractor,
                              style_text=style_text, style_weight=style_weight,
                              spec=self.version_spec)
            if skip_start:
                inputs = tuple(a[3:] for a in inputs)
            if skip_end:
                inputs = tuple(a[:-2] for a in inputs)
        else:
            parts = []
            n = len(segments)
            for i, (seg_text, lang) in enumerate(segments):
                seg_inputs = get_text(seg_text, lang, self.bert_extractor,
                                      style_text=style_text,
                                      style_weight=style_weight,
                                      spec=self.version_spec)
                if i > 0 or skip_start:  # trim all but the first boundary
                    seg_inputs = tuple(a[3:] for a in seg_inputs)
                if i < n - 1 or skip_end:
                    seg_inputs = tuple(a[:-2] for a in seg_inputs)
                parts.append(seg_inputs)
            inputs = tuple(np.concatenate([p[j] for p in parts], axis=0)
                           for j in range(6))
        emo = self._resolve_emotion(emotion, reference_audio, 1)
        return PreparedRequest(
            inputs=inputs, sid=self.resolve_speaker(speaker), emo=emo,
            sdp_ratio=float(sdp_ratio), noise_scale=float(noise_scale),
            noise_scale_w=float(noise_scale_w),
            length_scale=float(length_scale), seed=int(seed),
        )

    def infer_multilang(
        self,
        segments: Sequence[tuple[str, str]],
        speaker,
        sdp_ratio: float = 0.2,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        seed: int = 0,
    ) -> np.ndarray:
        """Mixed-language synthesis: per-segment features (with boundary
        trims) concatenated into one model call. Ref: infer.py:335-437."""
        req = self.prepare(
            None, speaker, segments=segments, sdp_ratio=sdp_ratio,
            noise_scale=noise_scale, noise_scale_w=noise_scale_w,
            length_scale=length_scale, seed=seed,
        )
        return self.run_prepared([req])[0]

    def infer_batch(
        self,
        texts: Sequence[str],
        speakers: Sequence,
        language="ZH",
        sdp_ratio: float = 0.2,
        noise_scale: float = 0.667,
        noise_scale_w: float = 0.8,
        length_scale: float = 1.0,
        seed: int = 0,
        max_batch: int = 16,
    ) -> list:
        """Batched synthesis -> trimmed float32 waveforms in text order. Up to
        `max_batch` texts share one call (run_prepared); a larger pile is
        length-sorted and cut into chunks (run_packed), so short texts never
        pad to the longest one's frames.

        `language` and the four knobs take one value for the whole batch or
        a per-item sequence."""
        n = len(texts)

        def per_item(v, cast):
            if isinstance(v, (str, int, float)):
                return [cast(v)] * n
            return [cast(x) for x in v]

        langs = per_item(language, str)
        knobs = {
            "sdp_ratio": per_item(sdp_ratio, float),
            "noise_scale": per_item(noise_scale, float),
            "noise_scale_w": per_item(noise_scale_w, float),
            "length_scale": per_item(length_scale, float),
        }
        reqs = [
            self.prepare(
                texts[i], speakers[i], language=langs[i], seed=seed,
                **{k: v[i] for k, v in knobs.items()},
            )
            for i in range(n)
        ]
        if len(reqs) <= max_batch:
            return self.run_prepared(reqs)
        return self.run_packed(reqs, max_batch=max_batch)
