"""PyTorch port, whole slice: `Synthesizer.infer` and `TTSEngine.run_prepared`
against the JAX package on the CPU, with the same random weights (see
tests/test_torch_modules.py for how they are made).

Noise: the two frameworks draw different random numbers, so the knobs run
at noise_scale = noise_scale_w = 0 (sdp_ratio > 0 still mixes the SDP in).
Tolerances: the durations `w` before the ceiling to 1e-5 relative (they are
exponentials of log-durations held to 1e-5); y_lengths and the 0/1
alignment exactly; the wave to fp32 max-abs-err 1e-4 (errors of ~1e-6 per
module compound through 3 encoder layers, the SDP spline, 3 flow couplings
and the vocoder).
"""

import numpy as np
import pytest
import torch

import jax

from bert_vits2_tpu.infer.api import PreparedRequest as JaxPreparedRequest
from bert_vits2_tpu.infer.api import TTSEngine as JaxTTSEngine
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import PreparedRequest, TTSEngine
from bert_vits2_tpu_torch.models import build_synthesizer
from test_torch_modules import TINY, random_synth_params
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

WAVE_ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxSynthesizer(JaxModelConfig(**TINY))
    params = random_synth_params(jax_model, seed=1)
    port = build_synthesizer(ModelConfig(**TINY), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    return jax_model, params, port


def _inputs(rng, lens, t):
    b = len(lens)
    ints = [rng.integers(1, hi, (b, t)) for hi in (20, 12, 3)]
    bert = [(0.2 * rng.normal(size=(b, t, 1024))).astype(np.float32)
            for _ in range(3)]
    return ints, bert


def test_infer_end_to_end(pair):
    jax_model, params, port = pair
    rng = np.random.default_rng(0)
    lens, t, max_frames = np.asarray([16, 11]), 16, 192
    (x, tone, lang), bert = _inputs(rng, lens, t)
    sid = np.asarray([0, 3])
    knobs = dict(noise_scale=0.0, noise_scale_w=0.0, sdp_ratio=0.4,
                 length_scale=np.asarray([1.0, 1.3], np.float32))

    def durations(mod, x, lens, sid, tone, lang, b1, b2, b3):
        g = mod._speaker(sid, None)
        x_h, _, _, x_mask = mod.enc_p(x, lens, tone, lang, b1, b2, b3, g=g)
        logw = (mod.sdp(x_h, x_mask, g=g, reverse=True, noise_scale=0.0) * 0.4
                + mod.dp(x_h, x_mask, g=g) * 0.6)
        return jax.numpy.exp(logw[..., 0]) * x_mask * knobs["length_scale"][:, None]

    run = jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, max_frames, method=JaxSynthesizer.infer,
        rngs={"noise": jax.random.key(0)}, **knobs))
    args = (x, lens, sid, tone, lang, *bert)
    want_wave, want_attn, want_ymask, want_ylen = map(np.asarray, run(params, *args))
    want_w = np.asarray(jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, method=durations,
        rngs={"noise": jax.random.key(0)}))(params, *args))

    targs = [torch.tensor(np.asarray(a)) for a in args]
    with torch.inference_mode():
        got_w = port._durations(*targs, knobs["length_scale"], 0.0, 0.4, None,
                                None)[0].numpy()
        wave, attn, y_mask, y_len = port.infer(*targs, max_frames, **knobs)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-5)
    assert np.array_equal(y_len.numpy(), want_ylen)
    assert (want_ylen < max_frames).all() and (want_ylen > lens).all()
    assert np.array_equal(attn.numpy(), want_attn)
    assert np.array_equal(y_mask.numpy(), want_ymask)
    assert np.abs(wave.numpy() - want_wave).max() <= WAVE_ATOL


def _requests(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n, sdp_ratio, ls in ((11, 0.2, 1.0), (20, 0.5, 1.2), (7, 0.0, 0.9)):
        (x, tone, lang), bert = _inputs(rng, [n], n)
        out.append(dict(inputs=(x[0], tone[0], lang[0], *(b[0] for b in bert)),
                        sid=n % 4, sdp_ratio=sdp_ratio, noise_scale=0.0,
                        noise_scale_w=0.0, length_scale=ls, seed=3))
    return out


def _engines(pair):
    jax_model, params, port = pair
    kw = dict(text_buckets=(16, 32), frames_per_token=4)
    jax_engine = JaxTTSEngine(jax_model, {"params": params},
                              bert_extractor=lambda *a, **k: None, **kw)
    return jax_engine, TTSEngine(port, device="cpu", **kw)


def test_run_prepared_matches_jax_engine(pair):
    """One batched call of three ragged requests (bucket 32, batch padded to
    4): the same trimmed waves and the same frame accounting."""
    jax_engine, engine = _engines(pair)
    reqs = _requests(seed=2)
    want = jax_engine.run_prepared([JaxPreparedRequest(**r) for r in reqs])
    got = engine.run_prepared([PreparedRequest(**r) for r in reqs])
    assert [len(w) for w in got] == [len(w) for w in want]
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) <= WAVE_ATOL
    for key in ("frames_capacity", "frames_delivered"):
        assert engine.stats[key] == jax_engine.stats[key]
    assert engine.stats["bytes_h2d"] > 0


def test_engine_shape_rules_match_jax(pair):
    """Buckets, frame caps, batch padding and the packing plan are the JAX
    engine's, so the two engines pick the same static shapes."""
    jax_engine, engine = _engines(pair)
    for t in (1, 16, 17, 32, 33, 100):
        assert engine._bucket(t) == jax_engine._bucket(t)
        for ls in (0.8, 1.0, 1.7):
            assert engine._frame_cap(t, ls) == jax_engine._frame_cap(t, ls)
    for n in (1, 2, 3, 5, 8, 9):
        assert np.array_equal(engine._pad_idx(list(range(n))),
                              jax_engine._pad_idx(list(range(n))))
    frames = np.asarray([70, 3, 129, 64, 65])
    assert engine.plan_packed(frames, 2) == jax_engine.plan_packed(frames, 2)
    reqs = _requests(seed=4)
    assert (engine.group_key(PreparedRequest(**reqs[1]))
            == jax_engine.group_key(JaxPreparedRequest(**reqs[1])))


def test_run_packed_returns_request_order(pair):
    """Length-sorted chunks of two; each wave equals its own single-request
    synthesis (zero noise, so batch company and frame cap do not matter)."""
    _, engine = _engines(pair)
    reqs = [PreparedRequest(**r) for r in _requests(seed=5)]
    packed = engine.run_packed(reqs, max_batch=2)
    frames = engine.predict_frames(reqs)
    for r, wave, f in zip(reqs, packed, frames):
        alone = engine.run_prepared([r])[0]
        assert len(wave) == len(alone) == f * engine.hop_length
        assert np.abs(wave - alone).max() <= 1e-5
