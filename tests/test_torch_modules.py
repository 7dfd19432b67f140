"""PyTorch port, module layer: each module of the synthesis path against its
JAX counterpart, on the CPU, with the same random weights.

One random JAX parameter tree for the whole tiny Synthesizer (shapes from
`jax.eval_shape` of its init, values from numpy; every parameter random,
the zero-initialized flow `post` and SDP `proj` convs included, else each
coupling would be the identity) is converted with `from_jax_params` and
loaded strictly into the port. Config: the tiny config of
tests/conftest.py with 3 encoder and 3 flow layers, so that the speaker
conditioning at layer 2 runs. BERT-like features are drawn at std 0.2 (the
1024-term projection otherwise carries ~1e-5 of fp32 rounding on the JAX
side alone).

Tolerance: fp32 max-abs-err <= 1e-5 on valid positions (the two frameworks
sum in different orders; values are O(1)).
"""

import functools
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.nn.attention import Encoder as JaxEncoder
from bert_vits2_tpu.nn.flows import Log as JaxLog
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.nn.flows import Log
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
TINY = dict(
    n_vocab=20, bert_dim=1024, spec_channels=33, segment_size=8,
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=3, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4), upsample_initial_channel=16,
    upsample_kernel_sizes=(8, 8), n_speakers=4, gin_channels=8,
    n_layers_trans_flow=3,
)


def random_tree(shapes, seed):
    """Random values for a tree of shapes: fan-in-scaled kernels, gains and
    LayerNorm scales near 1, everything else small and nonzero."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name, n = path[-1].key, rng.normal(size=s.shape)
        if name in ("kernel", "v"):
            w = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("g", "gamma"):
            w = 1.0 + 0.1 * n
        elif name in ("emb_rel_k", "emb_rel_v"):
            w = n / np.sqrt(s.shape[-1])
        elif name == "embedding":
            w = 0.5 * n
        else:
            w = 0.1 * n
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _synth_shapes(cfg, bert_dim):
    """The JAX Synthesizer's parameter shapes for a config (one trace per
    config and process: several files share a config)."""
    z = lambda *s, dt=jnp.float32: jnp.zeros(s, dt)  # noqa: E731
    return jax.eval_shape(lambda: JaxSynthesizer(cfg).init(
        {"params": jax.random.key(0), "noise": jax.random.key(1),
         "dropout": jax.random.key(2)},
        z(1, 8, dt=jnp.int32), jnp.asarray([8]), z(1, 16, 33), jnp.asarray([16]),
        z(1, dt=jnp.int32), z(1, 8, dt=jnp.int32), z(1, 8, dt=jnp.int32),
        z(1, 8, bert_dim), z(1, 8, bert_dim), z(1, 8, bert_dim),
        deterministic=True,
    ))["params"]


def random_synth_params(jax_model, seed, bert_dim=1024):
    """Random parameters for every leaf of the JAX Synthesizer. The
    posterior encoder `enc_q` draws from a stream of its own, so the other
    modules' values do not depend on it."""
    shapes = dict(_synth_shapes(jax_model.cfg, bert_dim))
    enc_q = shapes.pop("enc_q")
    params = random_tree(shapes, seed)
    params["enc_q"] = random_tree(enc_q, seed + 1000)
    return params


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxSynthesizer(JaxModelConfig(**TINY))
    params = random_synth_params(jax_model, seed=0)
    port = build_synthesizer(ModelConfig(**TINY), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    return jax_model, params, port


def _mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _cf(a):
    """[b, t, c] numpy -> [b, c, t] tensor (the port's layout)."""
    return _t(np.asarray(a).transpose(0, 2, 1))


def _err(got_cf, want_tc, mask):
    """max |port - jax| over valid positions; port [b, c, t], JAX [b, t, c]."""
    got = got_cf.numpy().transpose(0, 2, 1)
    return np.abs(got - np.asarray(want_tc))[mask.astype(bool)].max()


def _apply(jax_model, params, fn, *args):
    return jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, method=fn, rngs={"noise": jax.random.key(0)}))(
        params, *args)


@pytest.mark.parametrize("t", [16, 13])
def test_encoder(pair, t):
    """Relative-position encoder with speaker conditioning at layer 2; t = 13
    is not a multiple of 8 (dense path in JAX, K1's plain version here)."""
    _, params, port = pair
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 8)).astype(np.float32)
    m = _mask([t, t - 5], t)
    g = rng.normal(size=(2, 8)).astype(np.float32)
    enc = JaxEncoder(8, 16, 2, 3, kernel_size=3, gin_channels=8)
    want = jax.jit(lambda p, x, m, g: enc.apply({"params": p}, x, m, g=g))(
        params["enc_p"]["encoder"], x, m, g)
    with torch.inference_mode():
        got = port.enc_p.encoder(_cf(x), _t(m[:, None]), g=_t(g))
    assert _err(got, want, m) <= ATOL


def _text_inputs(rng, b, t, lens):
    ints = [rng.integers(1, hi, (b, t)) for hi in (20, 12, 3)]
    bert = [(0.2 * rng.normal(size=(b, t, 1024))).astype(np.float32)
            for _ in range(3)]
    return ints, bert, np.asarray(lens), np.asarray([0, 3][:b])


def test_text_encoder(pair):
    jax_model, params, port = pair
    rng = np.random.default_rng(1)
    (x, tone, lang), bert, lens, sid = _text_inputs(rng, 2, 16, [16, 10])

    def fn(mod, x, lens, sid, tone, lang, b1, b2, b3):
        g = mod._speaker(sid, None)
        return mod.enc_p(x, lens, tone, lang, b1, b2, b3, g=g)[:3]

    want = _apply(jax_model, params, fn, x, lens, sid, tone, lang, *bert)
    with torch.inference_mode():
        g = port.emb_g(_t(sid))
        got = port.enc_p(_t(x), _t(lens), _t(tone), _t(lang),
                         *(_cf(b) for b in bert), g=g)[:3]
    m = _mask(lens, 16)
    for gt, wt in zip(got, want):
        assert _err(gt, wt, m) <= ATOL


def test_duration_predictors(pair):
    """SDP in reverse (explicit noise z_in, the reversed chain without its
    first ConvFlow) and the deterministic DP. The noise is drawn at std 0.3:
    the inverse spline amplifies fp32 rounding, and at std 0.8 each
    framework's own fp32 result is already ~1e-5 from a float64 run."""
    jax_model, params, port = pair
    rng = np.random.default_rng(2)
    t = 16
    x = rng.normal(size=(2, t, 8)).astype(np.float32)
    m = _mask([16, 9], t)
    sid = np.asarray([1, 2])
    z_in = (0.3 * rng.normal(size=(2, t, 2))).astype(np.float32)

    def fn(mod, x, m, sid, z_in):
        g = mod._speaker(sid, None)
        return (mod.sdp(x, m, g=g, reverse=True, z_in=z_in),
                mod.dp(x, m, g=g))

    want_sdp, want_dp = _apply(jax_model, params, fn, x, m, sid, z_in)
    with torch.inference_mode():
        g = port.emb_g(_t(sid))
        got_sdp = port.sdp.reverse(_cf(x), _t(m[:, None]), _cf(z_in), g=g)
        got_dp = port.dp(_cf(x), _t(m[:, None]), g=g)
    assert _err(got_sdp, want_sdp, m) <= ATOL
    assert _err(got_dp, want_dp, m) <= ATOL


def test_log_flow():
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(size=(2, 5, 2))).astype(np.float32)
    m = _mask([5, 3], 5)
    (jy, jld), jr = (JaxLog().apply({}, x, m),
                     JaxLog().apply({}, x, m, reverse=True))
    ty, tld = Log()(_cf(x), _t(m[:, None]))
    tr = Log()(_cf(x), _t(m[:, None]), reverse=True)
    assert _err(ty, jy, m) <= ATOL and _err(tr, jr, m) <= ATOL
    assert np.abs(tld.numpy() - np.asarray(jld)).max() <= ATOL


def test_flow_reverse(pair):
    """4 transformer couplings in reverse, random (non-identity) `post`."""
    jax_model, params, port = pair
    rng = np.random.default_rng(4)
    t = 40
    z = rng.normal(size=(2, t, 8)).astype(np.float32)
    m = _mask([40, 29], t)
    sid = np.asarray([0, 3])

    def fn(mod, z, m, sid):
        return mod.flow(z, m, g=mod._speaker(sid, None), reverse=True)

    want = _apply(jax_model, params, fn, z, m, sid)
    with torch.inference_mode():
        got = port.flow(_cf(z), _t(m[:, None]), g=port.emb_g(_t(sid)),
                        reverse=True)
    assert _err(got, want, m) <= ATOL


@pytest.mark.parametrize("masked", [True, False])
def test_generator(pair, masked):
    """The vocoder, with and without `mrf_packed`. With it the C = 8 stage
    runs K2's plain version and the C = 4 stage the ResBlock modules;
    without, both run the modules. With a frame mask the padded tail stays
    silent."""
    jax_model, params, port = pair
    rng = np.random.default_rng(5)
    t = 24
    z = rng.normal(size=(2, t, 8)).astype(np.float32)
    lens = [24, 17] if masked else [24, 24]
    m = _mask(lens, t)
    sid = np.asarray([2, 1])

    def fn(mod, z, m, sid):
        return mod.dec(z, g=mod._speaker(sid, None), y_mask=m if masked else None)

    want = np.asarray(_apply(jax_model, params, fn, z, m, sid))
    with torch.inference_mode():
        packed = port.dec.pack_mrf()
        assert [w is None for w in packed] == [False, True]
        for mrf_packed in (packed, None):
            got = port.dec(_cf(z), g=port.emb_g(_t(sid)),
                           y_mask=_t(m) if masked else None,
                           mrf_packed=mrf_packed).numpy()
            assert np.abs(got - want).max() <= ATOL
            if masked:
                assert np.abs(got[1, 17 * 16:]).max() == 0.0


def test_generator_without_packed_weights_is_differentiable(pair):
    """`mrf_packed=None` (always so in training) runs the ResBlock modules:
    gradients reach the MRF convs of every stage, K2's stage included, and
    passing packed weights with gradients on is refused, not silently
    detached."""
    _, _, port = pair
    z = torch.randn(1, 8, 12, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    port.dec(z).sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for blk in port.dec.resblocks for p in blk.parameters())
    port.dec.zero_grad()
    with pytest.raises(RuntimeError):
        port.dec(z, mrf_packed=port.dec.pack_mrf())


def test_attention_dispatch_follows_grad_mode(pair, monkeypatch):
    """Gradients wanted -> the dense formula (differentiable, dropout in
    train() mode only), or with BV2_FUSED_ATTENTION_TRAIN=1 the wrapper of
    the fused kernels (on the CPU its plain version with the hash dropout);
    no-grad -> the K1 wrapper's inference launch. The wrapper returns a
    result with a graph for tensors that require grad."""
    from bert_vits2_tpu_torch.nn import attention as attn_mod
    from bert_vits2_tpu_torch.ops.attention import (
        banded_attention_plain,
        banded_rel_self_attention,
    )

    _, _, port = pair
    layer = port.enc_p.encoder.attn_layers[0]
    calls = []
    real = attn_mod.banded_rel_self_attention
    monkeypatch.setattr(attn_mod, "banded_rel_self_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.delenv("BV2_FUSED_ATTENTION_TRAIN", raising=False)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    m = _t(_mask([16, 11], 16)[:, None])
    with torch.no_grad():
        want = layer(x, m)
    assert calls == [1]
    xg = x.clone().requires_grad_(True)
    got = layer(xg, m)  # eval(), grad mode on: dense, same numbers
    assert calls == [1] and got.requires_grad
    assert (got - want)[:, :, :11].abs().max() <= ATOL
    got.sum().backward()
    assert xg.grad.abs().max() > 0 and layer.emb_rel_k.grad.abs().max() > 0
    layer.zero_grad()
    try:
        layer.train()
        torch.manual_seed(0)
        a = layer(x, m)
        b = layer(x, m)  # another dropout mask
        assert (a - b).abs().max() > 0 and calls == [1]
        monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
        fused = layer(xg, m)  # the fused op, hash dropout
        assert calls == [1, 1] and fused.requires_grad
    finally:
        layer.eval()
    q = torch.randn(1, 2, 16, 4, requires_grad=True)
    e = torch.randn(9, 4)
    out = banded_rel_self_attention(q, q, q, torch.ones(1, 16), e, e, 4)
    assert out.requires_grad
    assert torch.equal(out, banded_attention_plain(q, q, q, torch.ones(1, 16),
                                                   e, e, 4))