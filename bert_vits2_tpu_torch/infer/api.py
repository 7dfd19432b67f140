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
extractor's vector from reference audio or a CLAP text prompt).

The request pool (JAX `pack_requests`): every request tensor rides in two
contiguous buffers, one int32 and one float32 (`_pack_host`, the JAX
engine's layout), shipped in one pair of host-to-device copies
(`_put_pool`); a call gathers its rows on the device (`index_select`) and
slices the layout apart (`_unpack`). `run_prepared` without a pool packs
its own requests, `run_packed` ships the pile once and each chunk is a
gather with no request bytes copied.

The data-parallel engine (`mesh=`, JAX `TTSEngine(mesh=)`): one replica of
the model, its bf16 stages and K2's packed weights per device of the
mesh's data axis (one per distinct device: a mesh may name one card
twice); the padded batch's rows are split over the replicas, each replica
draws the whole padded batch's noise from the call's seed and keeps its
rows (`parallel/data.py`), so the waves equal the single engine's, and
every replica's launches go out before any host sync. The pool and the
BERT extractor stay on the first device; a replica's rows are gathered
there and copied to its device. A mesh with a model axis ([n_data,
n_model]) also splits the default extractor's BERT encoders over the first
data coordinate's model-axis devices (`text/bert_encoder.py:shard_bert`);
the synthesizer stays replicated, as in the JAX engine.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from bert_vits2_tpu_torch.device import resolve_device
from bert_vits2_tpu_torch.models.synthesizer import Synthesizer
from bert_vits2_tpu_torch.parallel import batch_sharding, data_shard, replicate
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
    bytes_h2d (request tensors shipped to the device: the pools' buffers).

    mesh: a one-process `parallel.Mesh` (`make_mesh(n_data, n_model,
    devices=...)`) for data-parallel synthesis (module note); the engine's
    device is then the mesh's first, and `device` is not read. The
    synthesizer is replicated over the data axis (the JAX engine's
    `replicate`), and the default BERT extractor takes the mesh, whose model
    axis splits each encoder over the first data coordinate's devices (JAX
    `AutoBertExtractor(mesh=mesh)`)."""

    def __init__(self, model: Synthesizer, spk2id: dict | None = None,
                 sampling_rate: int = 44100, bert_extractor=None,
                 text_buckets: Sequence[int] = (32, 64, 128, 256, 384),
                 frames_per_token: int = 6, frame_multiple: int = 64,
                 version_spec=None, emotion_extractor=None,
                 device: str | torch.device = "cuda", mesh=None):
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("the engine takes a one-process mesh "
                                 "(make_mesh(n_data, n_model, devices=...))")
            device = mesh.data_devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spk2id = spk2id or {}
        self.sampling_rate = sampling_rate
        # real per-language BERT on the engine's device when local weights
        # exist; loud-warned noise otherwise
        self.bert_extractor = bert_extractor or AutoBertExtractor(device=self.device,
                                                                  mesh=mesh)
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
        # (model, stages, mrf_packed) per device of the data axis: one copy
        # of the model per distinct device, its stages and K2's weights made
        # there
        self.replicas = [(self.model, self.stages, self.mrf_packed)]
        if mesh is not None:
            for d in mesh.data_devices:
                resolve_device(d)  # every device of the mesh must exist
            made = {id(self.model): self.replicas[0]}
            self.replicas = []
            for replica in replicate(mesh, self.model):
                if id(replica) not in made:
                    with torch.no_grad():
                        stages = replica.eval().compute_stages()
                    with torch.inference_mode():
                        made[id(replica)] = (replica, stages,
                                             replica.dec.pack_mrf(replica.compute_dtype))
                self.replicas.append(made[id(replica)])

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
        """Pad the batch to a power of two by repeating the last row; under
        a mesh, to a multiple of the data axis too (JAX api.py:595-602)."""
        n_pad = 1 << max(len(idx) - 1, 0).bit_length()
        if self.mesh is not None:
            n_pad = -(-n_pad // self.mesh.n_data) * self.mesh.n_data
        return np.asarray(list(idx) + [idx[-1]] * (n_pad - len(idx)), np.int32)

    # ---- the request pool (the JAX engine's packed transport) ----

    def _emo_kind(self, reqs) -> tuple[int, int]:
        """-> (e_int, e_f): 1/0 codebook-index column, float emo width."""
        emo0 = reqs[0].emo
        if emo0 is None:
            return 0, 0
        a = np.asarray(emo0)
        if np.issubdtype(a.dtype, np.integer):
            return 1, 0
        return 0, int(a.shape[-1])

    def _bert_offsets(self, t_x: int):
        """Per-row float-buffer layout: the three BERT widths are not
        uniform across version families (V1.1 takes a 768-d ja_bert,
        ModelConfig.ja_bert_dim). -> (dims, offsets[4])."""
        cfg = self.model.cfg
        dims = (cfg.bert_dim, getattr(cfg, "ja_bert_dim", cfg.bert_dim),
                cfg.bert_dim)
        offs = [0]
        for d in dims:
            offs.append(offs[-1] + t_x * d)
        return dims, offs

    def _pack_host(self, reqs: list, t_x: int):
        """-> (ints [b, 3*t_x + 2 + e_int] int32: phones, tones, languages,
        length, sid, codebook index; floats [b, sum(t_x * D_j) + 4 + e_f]
        float32: bert, ja_bert, en_bert, noise_scale, length_scale,
        noise_scale_w, sdp_ratio, emotion vector)."""
        b = len(reqs)
        e_int, e_f = self._emo_kind(reqs)
        dims, offs = self._bert_offsets(t_x)
        ints = np.zeros((b, 3 * t_x + 2 + e_int), np.int32)
        floats = np.zeros((b, offs[-1] + 4 + e_f), np.float32)
        for i, r in enumerate(reqs):
            tl = len(r.inputs[0])
            for j in range(3):
                ints[i, j * t_x: j * t_x + tl] = r.inputs[j]
            ints[i, 3 * t_x] = tl
            ints[i, 3 * t_x + 1] = r.sid
            if e_int:
                ints[i, 3 * t_x + 2] = int(np.asarray(r.emo).reshape(-1)[0])
            for j in range(3):
                flat = np.asarray(r.inputs[3 + j], np.float32).reshape(-1)
                floats[i, offs[j]: offs[j] + tl * dims[j]] = flat
            floats[i, offs[-1]: offs[-1] + 4] = (
                r.noise_scale, r.length_scale, r.noise_scale_w, r.sdp_ratio)
            if e_f:
                floats[i, offs[-1] + 4:] = np.asarray(r.emo, np.float32).reshape(-1)
        return ints, floats

    def _put_pool(self, ints: np.ndarray, floats: np.ndarray):
        """The two host buffers -> the device (the first of a mesh), one copy
        each, counted in bytes_h2d."""
        self.stats["bytes_h2d"] += ints.nbytes + floats.nbytes
        return (torch.from_numpy(ints).to(self.device),
                torch.from_numpy(floats).to(self.device))

    def _unpack(self, ibuf, fbuf, idx: torch.Tensor, t_x: int, e_int: int,
                e_f: int) -> dict:
        """Gather rows `idx` of the pool on its device and slice the packed
        layout apart -> the model's keyword tensors (integers int64, the
        slices contiguous; `emo` [b] int64 or [b, d] float32)."""
        dims, offs = self._bert_offsets(t_x)
        ii = ibuf.index_select(0, idx)
        ff = fbuf.index_select(0, idx)
        b = ii.shape[0]
        batch = {"x": ii[:, :t_x].long(), "tone": ii[:, t_x:2 * t_x].long(),
                 "language": ii[:, 2 * t_x:3 * t_x].long(),
                 "x_lengths": ii[:, 3 * t_x].long(), "sid": ii[:, 3 * t_x + 1].long()}
        for j, key in enumerate(("bert", "ja_bert", "en_bert")):
            batch[key] = ff[:, offs[j]:offs[j + 1]].reshape(b, t_x, dims[j]).contiguous()
        k0 = offs[-1]
        for j, key in enumerate(("noise_scale", "length_scale", "noise_scale_w",
                                 "sdp_ratio")):
            batch[key] = ff[:, k0 + j].contiguous()
        if e_int:
            batch["emo"] = ii[:, 3 * t_x + 2].long()
        elif e_f:
            batch["emo"] = ff[:, k0 + 4:].contiguous()
        return batch

    def pack_requests(self, reqs: Sequence[PreparedRequest]):
        """Pack a request pile into a device-resident pool: one pair of
        host-to-device copies for the whole pile; predict and synthesis
        calls then address rows by index (a gather on the device).
        -> (pool, t_x, (e_int, e_f))."""
        self._check_one_kind(reqs)
        t_x = self._bucket(max(len(r.inputs[0]) for r in reqs))
        ints, floats = self._pack_host(list(reqs), t_x)
        return self._put_pool(ints, floats), t_x, self._emo_kind(reqs)

    def model_inputs(self, reqs: Sequence[PreparedRequest]) -> dict:
        """The model's keyword tensors of one padded batch of `reqs`, as
        run_prepared builds them (pack_requests, then the gather), on the
        engine's device."""
        (ibuf, fbuf), t_x, kinds = self.pack_requests(reqs)
        idx = torch.from_numpy(self._pad_idx(list(range(len(reqs)))).astype(np.int64))
        return self._unpack(ibuf, fbuf, idx.to(ibuf.device), t_x, *kinds)

    def _run_rows(self, pool, rows: Sequence[int], seed: int,
                  max_frames: int | None = None) -> list:
        """The duration pass (max_frames None) or synthesis over pool rows
        `rows`, padded (`_pad_idx`), one call per replica on its share of
        the padded rows -> the replicas' outputs, in row order, still on
        their devices (no host sync here). The replicas draw the noise of
        the batch that one device pads to (a power of two), so a row's
        numbers do not depend on the mesh."""
        (ibuf, fbuf), t_x, (e_int, e_f) = pool
        idx = torch.from_numpy(self._pad_idx(list(rows)).astype(np.int64))
        idx = idx.to(ibuf.device)
        n = len(idx)
        n_draw = 1 << max(len(rows) - 1, 0).bit_length()
        parts = ([(slice(0, n), self.device)] if self.mesh is None
                 else batch_sharding(self.mesh, n))
        outs = []
        for (part, dev), (model, stages, mrf_packed) in zip(parts, self.replicas):
            batch = {k: v.to(dev) for k, v in
                     self._unpack(ibuf, fbuf, idx[part], t_x, e_int, e_f).items()}
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            shard = (contextlib.nullcontext() if self.mesh is None
                     else data_shard(part.start, n, draw_rows=n_draw))
            with shard:
                if max_frames is None:
                    batch.pop("noise_scale")
                    outs.append(model.predict_durations(generator=gen, **batch))
                else:
                    outs.append(model.infer(max_frames=max_frames, generator=gen,
                                            mrf_packed=mrf_packed, stages=stages,
                                            **batch))
        return outs

    def _predict_rows(self, pool, rows: list[int], seed: int) -> np.ndarray:
        """Duration pass over pool rows -> predicted frames [len(rows)]."""
        outs = self._run_rows(pool, rows, seed)
        return torch.cat([o.cpu() for o in outs]).numpy()[: len(rows)]

    # ---- public API ----

    @torch.inference_mode()
    def predict_frames(self, reqs: Sequence[PreparedRequest],
                       pool=None) -> np.ndarray:
        """Predicted output frames per request [n] from the duration-only
        pass; exact for run_prepared on the same batch (same noise). `pool`
        (from pack_requests over these reqs) skips shipping them again."""
        self._check_one_kind(reqs)
        if pool is None:
            pool = self.pack_requests(reqs)
        return self._predict_rows(pool, list(range(len(reqs))), reqs[0].seed)

    def _check_one_kind(self, reqs):
        if len({self.group_key(r)[1] for r in reqs}) > 1:
            raise ValueError("requests mix emotion input kinds")

    @torch.inference_mode()
    def run_prepared(self, reqs: Sequence[PreparedRequest],
                     predicted_frames: np.ndarray | None = None,
                     return_waves: bool = True, pool=None,
                     pool_rows: Sequence[int] | None = None) -> list:
        """Synthesize prepared requests in one batched call -> trimmed
        float32 waveforms in request order (or, with return_waves=False,
        their lengths in samples).

        The frame cap is the predicted maximum rounded up to the frame
        multiple, never above the worst-case tokens x frames_per_token
        bound; pass `predicted_frames` (from predict_frames over the same
        requests) to skip the duration pass. `pool` / `pool_rows` (from
        pack_requests over a pile that holds these requests) make the call a
        gather on the device with no request bytes copied; `reqs` must then
        be [pile[i] for i in pool_rows]."""
        self._check_one_kind(reqs)
        n_req = len(reqs)
        if pool is None:
            pool = self.pack_requests(reqs)
            pool_rows = range(n_req)
        if predicted_frames is None:
            predicted_frames = self._predict_rows(pool, list(pool_rows), reqs[0].seed)
        t_x = pool[1]
        idx = self._pad_idx(list(pool_rows))
        m = self.frame_multiple
        cap = -(-int(max(int(np.max(predicted_frames)), 1)) // m) * m
        max_frames = min(max(cap, m),
                         self._frame_cap(t_x, max(r.length_scale for r in reqs)))
        outs = self._run_rows(pool, list(pool_rows), reqs[0].seed, max_frames)
        y_len = torch.cat([o[3].cpu() for o in outs]).numpy()
        self.stats["frames_capacity"] += len(idx) * max_frames
        self.stats["frames_delivered"] += int(
            np.minimum(y_len[:n_req], max_frames).sum())
        lens = [min(int(y_len[i]), max_frames) * self.hop_length
                for i in range(n_req)]
        if not return_waves:
            return lens
        wave = torch.cat([o[0].cpu() for o in outs])[:n_req].numpy()
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
        own frame cap. Returns waveforms in request order. The pile ships to
        the device once (pack_requests); each chunk is a gather from that
        pool and re-predicts its own batch, since the SDP noise is
        positional."""
        self._check_one_kind(reqs)
        pool = self.pack_requests(reqs)
        frames = self.predict_frames(reqs, pool=pool)
        waves = {}
        for rows, _ in self.plan_packed(frames, max_batch):
            out = self.run_prepared([reqs[i] for i in rows],
                                    return_waves=return_waves, pool=pool,
                                    pool_rows=rows)
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
        e_int, e_f = {"vq210": (1, 0), "clap220": (0, 512)}.get(cfg.emotion, (0, 0))
        n = 0
        for t_x in list(buckets or self.text_buckets):
            max_frames = self._frame_cap(t_x, length_scale)
            _, offs = self._bert_offsets(t_x)
            for b in batch_sizes:
                # a pool of b zero requests made on the device: lengths t_x,
                # knobs 0.5
                ibuf = torch.zeros((b, 3 * t_x + 2 + e_int), dtype=torch.int32,
                                   device=self.device)
                ibuf[:, 3 * t_x] = t_x
                fbuf = torch.zeros((b, offs[-1] + 4 + e_f), device=self.device)
                fbuf[:, offs[-1]:offs[-1] + 4] = 0.5
                pool = ((ibuf, fbuf), t_x, (e_int, e_f))
                self._run_rows(pool, range(b), 0)
                self._run_rows(pool, range(b), 0, max_frames)
                n += 1
        for dev in set(self.mesh.data_devices if self.mesh is not None
                       else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
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
