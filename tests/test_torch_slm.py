"""PyTorch port, the SLM slice: the frozen WavLM, its loader and the sinc
resampler, the WavLM discriminator and the SLM losses, the port's step with
them, the reference encoder and a Synthesizer with n_speakers == 0, each
against the JAX package on the CPU with the same random weights.

The WavLM is transformers' `WavLMModel` on the tiny geometry of
tests/test_slm.py, built offline with every parameter redrawn from a numpy
seed (HF initializes biases to 0 and the gate constants to 1); its
state_dict loads into the port with `load_state_dict` and into the JAX
package with `import_torch_wavlm`. fp32; JAX at matmul precision
"highest".

Bounds: the WavLM's hidden states 2e-5 (the JAX package's own bound
against transformers, tests/test_slm.py); the resampler 1e-6 (one conv of
475 taps); the WavLM discriminator and the reference encoder 1e-5; the SLM
losses 1e-4 relative and their gradients 1e-3 of each gradient's norm
(the bounds of tests/test_torch_train_step.py); the n_speakers == 0
Synthesizer 1e-4 on valid positions (same file).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.models.discriminators import (
    WavLMDiscriminator as JaxWavLMDiscriminator,
)
from bert_vits2_tpu.models.reference_encoder import (
    ReferenceEncoder as JaxReferenceEncoder,
)
from bert_vits2_tpu.models.slm import WavLMConfig as JaxWavLMConfig
from bert_vits2_tpu.models.slm import (
    WavLMJax,
    import_torch_wavlm,
    make_resampler,
    make_slm_fns,
)
from bert_vits2_tpu_torch.compat.params import (
    from_jax_params,
    from_jax_wavlm_disc_params,
    from_jax_wavlm_params,
)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
    WavLMDiscriminator,
)
from bert_vits2_tpu_torch.models.reference_encoder import ReferenceEncoder
from bert_vits2_tpu_torch.models.slm import (
    SLM,
    Resampler,
    WavLM,
    WavLMConfig,
    load_wavlm,
    wavlm_state_dict,
)
from bert_vits2_tpu_torch.train import (
    DataConfig,
    Models,
    TrainConfig,
    init_train_state,
    make_train_step,
)
import golden_values
from test_torch_modules import _t, random_tree
from test_torch_train_modules import DD, MPD, TINY, patch_noise
from test_torch_train_step import BATCH_KEYS, DATA, MAS_DRAW, make_batch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY_HF_KW = dict(
    hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=64, conv_dim=[16, 16], conv_kernel=[10, 3],
    conv_stride=[5, 2], conv_bias=False, feat_extract_norm="group",
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=32, max_bucket_distance=50, do_stable_layer_norm=False,
    mask_time_prob=0.0, mask_feature_prob=0.0, layerdrop=0.0,
)
WD_CH = 8  # the WavLM discriminator's initial channels at the test size
TINY0 = dict(TINY, n_speakers=0)  # the reference encoder in place of emb_g


def _randomized(sd: dict, seed: int) -> dict:
    """Every tensor of an HF WavLM state_dict drawn anew: fan-in-scaled
    weights, norm scales and the gate constants near 1, the rest small."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        n = rng.normal(size=tuple(v.shape))
        if "norm" in k and k.endswith("weight") or "gru_rel_pos_const" in k:
            w = 1.0 + 0.1 * n
        elif k.endswith("original0") or k.endswith("weight_g"):
            w = 1.0 + 0.1 * np.abs(n)
        elif v.dim() >= 2 and "rel_attn_embed" not in k:
            w = n / np.sqrt(np.prod(v.shape[1:]))
        else:
            w = 0.3 * n
        out[k] = torch.tensor(w, dtype=torch.float32)
    return out


@pytest.fixture(scope="module")
def tiny():
    """(HF model, HF config, its randomized state_dict, the port's WavLM,
    the JAX config and params)."""
    from transformers import WavLMConfig as HFWavLMConfig
    from transformers import WavLMModel

    hc = HFWavLMConfig(**TINY_HF_KW)
    hf = WavLMModel(hc).eval()
    sd = _randomized(hf.state_dict(), seed=3)
    hf.load_state_dict(sd)
    port = WavLM(WavLMConfig.from_hf(hc)).eval()
    port.load_state_dict(wavlm_state_dict(sd), strict=True)
    jcfg = JaxWavLMConfig.from_hf(hc)
    return hf, hc, sd, port, jcfg, import_torch_wavlm(sd, jcfg)


def _wave(b, t, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t)).astype(np.float32) * 0.1


def test_wavlm_hidden_states_match_jax_and_transformers(tiny):
    hf, _, _, port, jcfg, params = tiny
    wave = _wave(2, 1200)
    with torch.no_grad():
        got = [h.numpy() for h in port(_t(wave))]
        hf_hs = [h.numpy() for h in hf(_t(wave), output_hidden_states=True).hidden_states]
    want = WavLMJax(jcfg).apply({"params": params}, wave)
    assert len(got) == len(want) == len(hf_hs) == jcfg.num_layers + 1
    for i, (g, w, h) in enumerate(zip(got, want, hf_hs)):
        assert g.shape == np.asarray(w).shape == (2, 119, 32)
        assert np.abs(g - np.asarray(w)).max() <= 2e-5, i
        assert np.abs(g - h).max() <= 2e-5, i
    # the JAX tree back into the port: the same model (the positional conv's
    # weight norm is recomputed from the resolved kernel: rounding only)
    again = WavLM(port.cfg).eval()
    again.load_state_dict(from_jax_wavlm_params(params, port.cfg), strict=True)
    with torch.no_grad():
        back = [h.numpy() for h in again(_t(wave))]
    for g, b in zip(got, back):
        assert np.abs(g - b).max() <= 1e-5
    # the bucket of rel = k - q equals transformers' at every distance
    from bert_vits2_tpu_torch.models.slm import _rel_pos_bucket

    att = hf.encoder.layers[0].attention
    rel = torch.arange(-120, 121)
    assert torch.equal(_rel_pos_bucket(rel, 32, 50),
                       att._relative_positions_bucket(rel))


@pytest.mark.parametrize("layout", ["parametrizations", "weight_g"])
def test_load_wavlm_reads_either_weight_norm_layout(tiny, tmp_path, layout):
    """An HF checkpoint directory, with the positional conv's weight norm
    under either name (the second also with a head model's `wavlm.` prefix
    and the training-time mask embedding), loads strictly and computes the
    port's hidden states."""
    _, hc, sd, port, _, _ = tiny
    if layout == "weight_g":
        pre = "encoder.pos_conv_embed.conv."
        sd = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in sd.items()}
        assert pre + "weight_g" in sd
        sd = {"wavlm." + k: v for k, v in sd.items()}
        sd["wavlm.masked_spec_embed"] = torch.zeros(32)
        sd["lm_head.weight"] = torch.zeros(4, 32)
    hc.to_json_file(str(tmp_path / "config.json"))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model, cfg = load_wavlm(str(tmp_path), device="cpu")
    assert cfg == port.cfg and not any(p.requires_grad for p in model.parameters())
    wave = _t(_wave(1, 900, seed=1))
    with torch.no_grad():
        for a, b in zip(model(wave), port(wave)):
            assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        load_wavlm(str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("orig,new", [(44100, 16000), (16000, 16000)])
def test_resampler_matches_jax(orig, new):
    wave = _wave(2, 3001, seed=2)
    got = Resampler(orig, new)(_t(wave)).numpy()
    want = np.asarray(make_resampler(orig, new)(jnp.asarray(wave)))
    assert got.shape == want.shape == (2, -(-3001 * new // orig))
    assert np.abs(got - want).max() <= 1e-6
    if orig == 44100:
        assert Resampler(orig, new).kernel.shape == (160, 1, 475)


def _wd_pair(seed, slm_hidden=32, slm_layers=4):
    jwd = JaxWavLMDiscriminator(slm_hidden, slm_layers, WD_CH)
    p = random_tree(jax.eval_shape(lambda: jwd.init(
        jax.random.key(0), jnp.zeros((1, 8, slm_hidden * slm_layers))))["params"],
        seed)
    wd = WavLMDiscriminator(slm_hidden, slm_layers, WD_CH)
    wd.load_state_dict(from_jax_wavlm_disc_params(p), strict=True)
    return jwd, p, wd


def test_wavlm_discriminator_matches_jax():
    jwd, p, wd = _wd_pair(seed=5)
    x = np.random.default_rng(4).normal(size=(2, 21, 128)).astype(np.float32)
    want = np.asarray(jwd.apply({"params": p}, x))
    with torch.no_grad():
        got = wd(_t(x.transpose(0, 2, 1))).numpy()
    assert got.shape == want.shape == (2, 21)
    assert np.abs(got - want).max() <= 1e-5


@pytest.fixture(scope="module")
def slm_losses(tiny):
    """The JAX package's SLM losses on one real and one fake 44.1 kHz
    slice: the WavLM discriminator's loss and gradient (train_ms.py:558-568),
    the feature loss and the generator's adversarial term, and the gradient
    of their sum with respect to the fake wave (one jitted function)."""
    *_, jcfg, params = tiny
    slm_embed, slm_feature_fn = make_slm_fns(params, jcfg, 44100, 16000)
    p_slm = slm_embed.params
    jwd, p_wd, wd = _wd_pair(seed=7)
    rng = np.random.default_rng(8)
    ys, yh = (rng.uniform(-0.5, 0.5, (2, 2205)).astype(np.float32) for _ in range(2))
    sg = jax.lax.stop_gradient

    @jax.jit
    def run(p_slm, p_wd, ys, yh):
        def wd_loss(p):
            d_r = jwd.apply({"params": p}, sg(slm_embed(p_slm, ys)))
            d_g = jwd.apply({"params": p}, sg(slm_embed(p_slm, yh)))
            return jnp.mean((1.0 - d_r) ** 2) + jnp.mean(d_g ** 2)

        def g_loss(yh):
            lm = sum(jnp.mean(jnp.abs(sg(r) - g)) for r, g in zip(
                slm_feature_fn(p_slm, sg(ys)), slm_feature_fn(p_slm, yh)))
            d_g = jwd.apply({"params": p_wd}, slm_embed(p_slm, yh))
            lm_gen = jnp.mean((1.0 - d_g) ** 2)
            return lm + lm_gen, (lm, lm_gen)

        loss_wd, grads_wd = jax.value_and_grad(wd_loss)(p_wd)
        (_, (lm, lm_gen)), d_yh = jax.value_and_grad(g_loss, has_aux=True)(yh)
        return loss_wd, grads_wd, lm, lm_gen, d_yh

    return wd, (ys, yh), jax.device_get(run(p_slm, p_wd, ys, yh))


def test_slm_losses_and_gradients_match_jax(tiny, slm_losses):
    """The port's SLM (resampler, WavLM, layer-major stacking) and WavLM
    discriminator, with the formulas of the port's step."""
    port = tiny[3]
    wd, (ys, yh), (loss_wd, grads_wd, lm, lm_gen, d_yh) = slm_losses
    slm = SLM(port, 44100, 16000)
    y, y_hat = _t(ys), _t(yh).requires_grad_(True)
    with torch.no_grad():
        hs_real = slm(y)
    hs_fake = slm(y_hat)
    emb_fake = slm.embed(hs_fake)
    assert emb_fake.shape == (2, 4 * 32, hs_fake[0].shape[1])
    got_wd = (torch.mean((1.0 - wd(slm.embed(hs_real))) ** 2)
              + torch.mean(wd(emb_fake.detach()) ** 2))
    got_wd.backward()
    got_lm = sum(torch.mean(torch.abs(r - f)) for r, f in zip(hs_real, hs_fake))
    got_gen = torch.mean((1.0 - wd(emb_fake)) ** 2)
    (got_lm + got_gen).backward()
    for got, want in ((got_wd, loss_wd), (got_lm, lm), (got_gen, lm_gen)):
        assert abs(float(got.detach()) - float(want)) <= 1e-4 * abs(float(want))
    assert not any(p.grad is not None for p in slm.parameters())
    want_g = {k: v.numpy() for k, v in from_jax_wavlm_disc_params(grads_wd).items()}
    # the generator's backward added its term to wd's grads: compare the
    # discriminator's own update from a fresh pass
    wd.zero_grad()
    (torch.mean((1.0 - wd(slm.embed(hs_real))) ** 2)
     + torch.mean(wd(emb_fake.detach()) ** 2)).backward()
    for name, p in wd.named_parameters():
        rel = np.abs(p.grad.numpy() - want_g[name]).max() / np.linalg.norm(want_g[name])
        assert rel <= 1e-3, (name, rel)
    rel = np.abs(y_hat.grad.numpy() - d_yh).max() / np.linalg.norm(d_yh)
    assert rel <= 1e-3


def _tiny_slm(seed=0, input_sr=DATA["sampling_rate"]):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        wavlm = WavLM(WavLMConfig.from_hf(TINY_HF_KW))
    return SLM(wavlm, input_sr, 16000)


def test_train_step_with_the_slm_losses():
    """Two steps of the port's step with the SLM: the JAX step's metric
    names, the WavLM discriminator moves, the frozen WavLM does not and
    collects no gradient, and loss/g/total is the sum of its terms, the two
    SLM terms included."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        synth = build_synthesizer(ModelConfig(**TINY), device="cpu")
        mpd, dd = MultiPeriodDiscriminator(**MPD), DurationDiscriminator(**DD)
        wd = WavLMDiscriminator(32, 4, WD_CH)
    slm = _tiny_slm()
    models = Models(synth, mpd, dd, wd)
    cfg = TrainConfig(learning_rate=1e-3)
    state = init_train_state(models, cfg)
    for half in (models, models._replace(wavlm_disc=None)):  # each needs the other
        with pytest.raises(ValueError, match="SLM"):
            make_train_step(half, cfg, DataConfig(**DATA), TINY["segment_size"],
                            slm=None if half is models else slm)
    step = make_train_step(models, cfg, DataConfig(**DATA), TINY["segment_size"],
                           slm=slm)
    wd_before = [p.detach().clone() for p in wd.parameters()]
    slm_before = [p.detach().clone() for p in slm.parameters()]
    batch = {k: _t(v) for k, v in make_batch(seed=3).items()}
    gen = torch.Generator().manual_seed(0)
    names = {"loss/d/total", "grad_norm_d", "loss/dur_disc/total",
             "grad_norm_dur", "loss/wd/total", "grad_norm_wd", "loss/g/gen",
             "loss/g/fm", "loss/g/mel", "loss/g/dur", "loss/g/kl",
             "loss/g/dur_gen", "loss/g/lm", "loss/g/lm_gen", "loss/g/total",
             "grad_norm_g", "learning_rate"}
    for i in range(2):
        state, metrics = step(state, batch, gen, 1e-3)
        assert set(metrics) == names
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        parts = sum(float(v) for k, v in metrics.items()
                    if k.startswith("loss/g/") and k != "loss/g/total")
        assert float(metrics["loss/g/total"]) == pytest.approx(parts, rel=1e-5)
        assert float(metrics["loss/g/lm"]) > 0 and float(metrics["loss/g/lm_gen"]) > 0
    assert state.step == 2 and state.opt_wd is not None
    assert all(not torch.equal(p.detach(), o) for p, o in zip(wd.parameters(), wd_before))
    assert all(torch.equal(p, o) for p, o in zip(slm.parameters(), slm_before))
    assert all(p.grad is None and not p.requires_grad for p in slm.parameters())
    assert not slm.training and wd.training


def test_reference_encoder_matches_jax():
    """Six weight-normed stride-2 convs, the channel-major flatten, the GRU
    (every flax gate bias random, so torch's r, z and n bias blocks all
    carry one) and the projection."""
    jref = JaxReferenceEncoder(33, 8)
    spec = np.random.default_rng(9).normal(size=(3, 40, 33)).astype(np.float32)
    p = random_tree(jax.eval_shape(lambda: jref.init(
        jax.random.key(0), jnp.zeros((1, 40, 33))))["params"], seed=11)
    port = ReferenceEncoder(33, 8)
    sd = {k[len("ref_enc."):]: v for k, v in from_jax_params({"ref_enc": p}).items()}
    port.load_state_dict(sd, strict=True)
    want = np.asarray(jref.apply({"params": p}, spec))
    with torch.no_grad():
        got = port(_t(spec)).numpy()
    assert got.shape == want.shape == (3, 8)
    assert np.abs(got - want).max() <= 1e-5


NO_SPEAKERS = os.path.join(os.path.dirname(__file__), "goldens", "no_speakers.npz")
NO_SPEAKERS_INFER = ("x", "x_lengths", "sid", "tone", "language", "bert", "ja_bert",
                     "en_bert")
NO_SPEAKERS_SEED, NO_SPEAKERS_MAS_NOISE = 6, 0.01  # the forward's noise tape, MAS noise
NO_SPEAKERS_FRAMES = 40  # infer's frame cap


def no_speakers_inputs():
    """The tiny JAX Synthesizer with n_speakers == 0, a random tree for it and
    one batch: what tests/goldens/make_no_speakers.py computes the JAX
    forward (the noise tape, NO_SPEAKERS_SEED) and infer (zero noise,
    NO_SPEAKERS_FRAMES frames, y = the batch's spec) from."""
    jax_model = JaxSynthesizer(JaxModelConfig(**TINY0))
    z = lambda *s, dt=jnp.float32: jnp.zeros(s, dt)  # noqa: E731
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)},
        z(1, 8, dt=jnp.int32), jnp.asarray([8]), z(1, 16, 33), jnp.asarray([16]),
        z(1, dt=jnp.int32), z(1, 8, dt=jnp.int32), z(1, 8, dt=jnp.int32),
        z(1, 8, 16), z(1, 8, 16), z(1, 8, 16), deterministic=True))["params"]
    return jax_model, random_tree(shapes, seed=12), make_batch(seed=4)


def no_speakers_fingerprint(params, batch) -> np.ndarray:
    """Of the tree, the batch, the model config and the calls' constants."""
    return golden_values.fingerprint(params, batch, TINY0, NO_SPEAKERS_SEED,
                                     NO_SPEAKERS_MAS_NOISE, NO_SPEAKERS_FRAMES)


@pytest.fixture(scope="module")
def no_speakers():
    """A tiny Synthesizer with n_speakers == 0, random weights in both
    packages, and the JAX forward and infer on one batch, from
    tests/goldens/no_speakers.npz (whose fingerprint of the tree and the
    batch must match)."""
    _, params, batch = no_speakers_inputs()
    assert "ref_enc" in params and "emb_g" not in params
    port = build_synthesizer(ModelConfig(**TINY0), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    want = golden_values.load(NO_SPEAKERS, no_speakers_fingerprint(params, batch),
                              "tests/goldens/make_no_speakers.py")
    want_inf = [want[f"inf/{i}"] for i in range(4)]
    return port, batch, golden_values.pick(want, "fwd/"), want_inf


def test_no_speakers_forward_matches_jax(no_speakers, monkeypatch):
    port, batch, want, _ = no_speakers
    patch_noise(monkeypatch, seed=NO_SPEAKERS_SEED, keep_layout=(MAS_DRAW,))
    with torch.no_grad():
        got = port.eval()(*(_t(batch[k]) for k in BATCH_KEYS),
                          mas_noise_scale=NO_SPEAKERS_MAS_NOISE)
    assert np.array_equal(got["attn"].numpy(), want["attn"])
    assert np.array_equal(got["ids_slice"].numpy(), want["ids_slice"])
    assert np.abs(got["g"].numpy() - want["g"]).max() <= 1e-5
    # the slice: every sample of it lies in a valid frame
    err = np.abs(got["wave_slice"].numpy() - want["wave_slice"]).max()
    assert err <= 1e-4
    y_mask = got["y_mask"].numpy()
    for name in ("z_p", "m_q", "logs_q"):
        err = np.abs((got[name].numpy() - np.asarray(want[name]).transpose(0, 2, 1))
                     * y_mask).max()
        assert err <= 1e-4, (name, err)


def test_no_speakers_infer_matches_jax(no_speakers):
    port, batch, _, (w_wave, w_attn, w_mask, w_len) = no_speakers
    keys = NO_SPEAKERS_INFER
    with torch.no_grad():
        wave, attn, y_mask, y_len = port.eval().infer(
            *(_t(batch[k]) for k in keys), NO_SPEAKERS_FRAMES, noise_scale=0.0,
            noise_scale_w=0.0, y=_t(batch["spec"]))
        with pytest.raises(ValueError, match="n_speakers == 0"):
            port.infer(*(_t(batch[k]) for k in keys), NO_SPEAKERS_FRAMES)
    assert np.array_equal(y_len.numpy(), w_len)
    assert np.array_equal(attn.numpy(), w_attn)
    hop = 16
    valid = np.repeat(y_mask.numpy(), hop, axis=1)
    assert np.abs((wave.numpy() - w_wave) * valid).max() <= 1e-4


_NO_TRANSFORMERS = """
import sys
sys.modules["transformers"] = None  # any import of it now raises
import json, torch
torch.set_num_threads(1)  # a tiny step: threads beside the test runner's workers only spin
from bert_vits2_tpu_torch.models.slm import WavLM, WavLMConfig, SLM, load_wavlm
from bert_vits2_tpu_torch.train.trainer import build_models, init_params
from bert_vits2_tpu_torch.train import (DataConfig, TrainConfig,
                                        init_train_state, make_train_step)
from bert_vits2_tpu_torch.models import reference_encoder
from bert_vits2_tpu_torch.config import ModelConfig

path, tiny = sys.argv[1], json.loads(sys.argv[2])
cfg = WavLMConfig.from_hf(tiny)
raised = []
try:
    load_wavlm(path)
except RuntimeError:
    raised.append("load_wavlm")
wavlm, cfg = load_wavlm(path, device="cpu")
mcfg = ModelConfig(**json.loads(sys.argv[3]))
models = init_params(build_models(mcfg, use_wavlm_disc=True, device="cpu",
                                  wavlm=cfg), mcfg)
data = DataConfig(**json.loads(sys.argv[4]))
tcfg = TrainConfig()
step = make_train_step(models, tcfg, data, mcfg.segment_size,
                       slm=SLM(wavlm, data.sampling_rate, 16000))
g = torch.Generator().manual_seed(0)
b, t_x, t_y = 2, 7, 20
batch = dict(x=torch.randint(1, 20, (b, t_x), generator=g),
             x_lengths=torch.tensor([t_x, t_x - 2]),
             spec=0.3 * torch.randn(b, t_y, 33, generator=g),
             spec_lengths=torch.tensor([t_y, t_y - 4]),
             wave=torch.rand(b, t_y * 16, generator=g) - 0.5,
             sid=torch.tensor([0, 1]),
             tone=torch.randint(0, 12, (b, t_x), generator=g),
             language=torch.randint(0, 3, (b, t_x), generator=g),
             bert=0.3 * torch.randn(b, t_x, 16, generator=g),
             ja_bert=0.3 * torch.randn(b, t_x, 16, generator=g),
             en_bert=0.3 * torch.randn(b, t_x, 16, generator=g))
_, metrics = step(init_train_state(models, tcfg), batch, g, 1e-4)
print(json.dumps({"raised": raised, "wd": float(metrics["loss/wd/total"]),
                  "transformers": sys.modules["transformers"] is None}))
"""


def test_slm_path_needs_no_transformers(tmp_path):
    """With `transformers` hidden, in a fresh interpreter with no card:
    load_wavlm defaults to the card and raises, then loads on the CPU a
    checkpoint directory that the port's own WavLM wrote, and one step of
    the training step with the SLM losses runs (build_models with the
    loaded WavLM's width check, init_params, the step)."""
    wavlm = WavLM(WavLMConfig.from_hf(TINY_HF_KW))
    (tmp_path / "config.json").write_text(json.dumps(wavlm.cfg.to_hf()))
    torch.save(wavlm.state_dict(), tmp_path / "pytorch_model.bin")
    mcfg = {k: v for k, v in TINY.items()}
    mcfg.update(slm_hidden=32, slm_layers=4, slm_initial_channel=WD_CH)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", _NO_TRANSFORMERS, str(tmp_path),
         json.dumps(TINY_HF_KW), json.dumps(mcfg), json.dumps(DATA)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["raised"] == ["load_wavlm"] and res["transformers"]
    assert np.isfinite(res["wd"])
