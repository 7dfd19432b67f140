"""PyTorch port, the engine's request pool (`pack_requests`), mirroring
tests/test_packing.py on the port: the packed host layout against the JAX
engine's, array for array, for a V2.3, a V1.1 (768-d ja_bert), a V2.1
(`vq210`: codebook index and vector) and a V2.2 (`clap220`) engine; then, on
the port alone, the pool's waves against the unpooled route bit for bit, one
pair of host-to-device copies per pile, request order and lengths, and the
duration pass through a pool against synthesis.

The tiny config of tests/test_torch_modules.py with 16-d BERT features and
random weights from a seed; requests from numpy seeds. Everything is exact:
the pool route and the unpooled one run the same operations on the same
values, and the host layout is integer and float32 copying.
"""

import numpy as np
import pytest

from bert_vits2_tpu.compat import versions as jax_versions
from bert_vits2_tpu.infer.api import PreparedRequest as JaxPreparedRequest
from bert_vits2_tpu.infer.api import TTSEngine as JaxTTSEngine
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu_torch.compat import versions
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import PreparedRequest, TTSEngine
from bert_vits2_tpu_torch.models import build_synthesizer
from test_torch_modules import TINY
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(TINY, bert_dim=16, ja_bert_dim=16)
ENGINE_KW = dict(text_buckets=(8, 16, 32), frames_per_token=6, frame_multiple=8)


@pytest.fixture(scope="module")
def engine():
    return TTSEngine(build_synthesizer(ModelConfig(**CFG), device="cpu", seed=0),
                     device="cpu", **ENGINE_KW)


def _req(cfg, rng, t, emo=None, sdp_ratio=0.0, length_scale=1.0, seed=0,
         noise_scale=0.667, cls=PreparedRequest):
    inputs = (
        rng.integers(1, cfg.n_vocab, t).astype(np.int32),
        rng.integers(0, cfg.num_tones, t).astype(np.int32),
        rng.integers(0, cfg.num_languages, t).astype(np.int32),
        rng.normal(size=(t, cfg.bert_dim)).astype(np.float32),
        rng.normal(size=(t, cfg.ja_bert_dim)).astype(np.float32),
        rng.normal(size=(t, cfg.bert_dim)).astype(np.float32),
    )
    return cls(inputs=inputs, sid=int(rng.integers(0, cfg.n_speakers)), emo=emo,
               sdp_ratio=sdp_ratio, length_scale=length_scale, seed=seed,
               noise_scale=noise_scale)


EMOTIONS = {  # family, the emotion rows of three requests
    "1.1": lambda rng: [None] * 3,
    "2.3": lambda rng: [None] * 3,
    "2.1-index": lambda rng: [np.full((1,), i, np.int32) for i in (0, 3, 7)],
    "2.1-vector": lambda rng: [rng.normal(size=(1, 1024)).astype(np.float32)
                               for _ in range(3)],
    "2.2": lambda rng: [rng.normal(size=(1, 512)).astype(np.float32)
                        for _ in range(3)],
}


@pytest.mark.parametrize("case", sorted(EMOTIONS))
def test_pack_host_matches_jax(case):
    """`_emo_kind`, `_bert_offsets` and `_pack_host` give the JAX engine's
    arrays for the same requests, in each family's widths (V1.1's 768-d
    ja_bert among them)."""
    family = case.split("-")[0]
    over = versions.spec_for(family).model_overrides()
    assert over == jax_versions.spec_for(family).model_overrides()
    cfg = ModelConfig(**dict(CFG, **over))
    port = TTSEngine(build_synthesizer(cfg, device="cpu", seed=0), device="cpu",
                     **ENGINE_KW)
    jax_engine = JaxTTSEngine(JaxSynthesizer(JaxModelConfig(**dict(CFG, **over))), {},
                              bert_extractor=lambda *a, **k: None, **ENGINE_KW)
    rng = np.random.default_rng(1)
    emos = EMOTIONS[case](rng)
    reqs = [_req(cfg, np.random.default_rng(10 + i), t, emo=e, sdp_ratio=0.1 * i,
                 length_scale=1.0 + 0.1 * i, seed=4)
            for i, (t, e) in enumerate(zip((5, 13, 9), emos))]
    jax_reqs = [JaxPreparedRequest(**r._asdict()) for r in reqs]
    assert port._emo_kind(reqs) == jax_engine._emo_kind(jax_reqs)
    t_x = port._bucket(13)
    assert port._bert_offsets(t_x) == jax_engine._bert_offsets(t_x)
    got, want = port._pack_host(reqs, t_x), jax_engine._pack_host(jax_reqs, t_x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _pile(cfg, n, seed, lengths=(9, 16)):
    rng = np.random.default_rng(seed)
    return [_req(cfg, rng, int(t), sdp_ratio=0.3, seed=seed)
            for t in rng.integers(lengths[0], lengths[1] + 1, n)]


def test_pool_waves_equal_unpooled_bit_for_bit(engine):
    """Chunks of a pile gathered from its pool give the waves that the same
    chunks give when run_prepared packs them itself (one text bucket, the
    same seed, nonzero noise): bit for bit."""
    reqs = _pile(engine.model.cfg, 5, seed=2)
    pool = engine.pack_requests(reqs)
    for rows in ([0, 2, 4], [3, 1]):
        sub = [reqs[i] for i in rows]
        pooled = engine.run_prepared(sub, pool=pool, pool_rows=rows)
        alone = engine.run_prepared(sub)
        assert [len(w) for w in pooled] == [len(w) for w in alone]
        for a, b in zip(pooled, alone):
            assert np.array_equal(a, b)


def test_bytes_h2d_one_pair_per_pile(engine):
    """A pile costs its two buffers' bytes once; chunks through the pool add
    none, and run_packed ships its pile once."""
    reqs = _pile(engine.model.cfg, 6, seed=3)
    t_x = engine._bucket(max(len(r.inputs[0]) for r in reqs))
    ints, floats = engine._pack_host(reqs, t_x)
    pair = ints.nbytes + floats.nbytes
    before = engine.stats["bytes_h2d"]
    pool = engine.pack_requests(reqs)
    assert engine.stats["bytes_h2d"] - before == pair
    (ibuf, fbuf), _, _ = pool
    assert np.array_equal(ibuf.numpy(), ints) and np.array_equal(fbuf.numpy(), floats)
    before = engine.stats["bytes_h2d"]
    engine.predict_frames(reqs, pool=pool)
    engine.run_prepared(reqs[:4], pool=pool, pool_rows=range(4))
    assert engine.stats["bytes_h2d"] == before
    engine.run_packed(reqs, max_batch=2)
    assert engine.stats["bytes_h2d"] - before == pair


def test_run_packed_keeps_order_and_lengths(engine):
    """run_packed returns waves in request order with the per-request
    lengths of unpacked synthesis (sdp_ratio 0: the durations do not depend
    on the batch layout), and return_waves=False gives those lengths."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(4)
    reqs = [_req(cfg, rng, t) for t in (4, 12, 6, 10, 5)]
    packed = engine.run_packed(reqs, max_batch=2)
    singles = [engine.run_prepared([r])[0] for r in reqs]
    assert [len(p) for p in packed] == [len(s) for s in singles]
    assert engine.run_packed(reqs, max_batch=2, return_waves=False) == [
        len(p) for p in packed]
    assert engine.run_prepared(reqs, return_waves=False) == [
        len(w) for w in engine.run_prepared(reqs)]


def test_predict_frames_through_a_pool_equals_synthesis(engine):
    """The duration pass through a pool is the prefix of synthesis: the
    trimmed lengths are min(prediction, cap) frames."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(0)
    reqs = [_req(cfg, rng, t, sdp_ratio=0.5) for t in (5, 8, 11)]
    pool = engine.pack_requests(reqs)
    pred = engine.predict_frames(reqs, pool=pool)
    assert np.array_equal(pred, engine.predict_frames(reqs))
    waves = engine.run_prepared(reqs, pool=pool, pool_rows=range(3))
    m = engine.frame_multiple
    cap = min(-(-int(pred.max()) // m) * m, engine._frame_cap(engine._bucket(11), 1.0))
    for p, w in zip(pred, waves):
        assert len(w) == min(int(p), cap) * engine.hop_length
