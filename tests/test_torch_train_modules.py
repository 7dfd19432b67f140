"""PyTorch port, training slice, module layer: each module the training
step adds against its JAX counterpart on the CPU, with the same random
weights (every parameter random, the zero-initialized flow `post` and SDP
`proj` convs included) and the same inputs from numpy seeds.

Config: the tiny training config of tests/test_train.py (16-d BERT
features) with 3 encoder layers and 2 flow couplings of 3 layers (the
speaker conditioning before layer 2 then runs and its parameters exist on
both sides; two couplings keep the JAX compile of the step short); the multi-period discriminator at its
test-size overrides (periods 2 and 3, `p_channels=(8, 16)`, three
scale-discriminator layers). fp32; JAX at matmul precision "highest".

Noise: the JAX modules draw from `jax.random.normal`, the port from
`ops/noise.py`; both are replaced for the duration of a test by a tape that
hands out the same numpy-seeded numbers in the order of the draws.

Tolerance: max-abs-err <= 1e-5 on valid positions (the two frameworks sum in
different orders; values are O(1)); the SDP's summed NLL, O(100), to 1e-5
relative.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bert_vits2_tpu.models import DurationDiscriminator as JaxDurationDiscriminator
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import MultiPeriodDiscriminator as JaxMPD
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.nn.flows import ConvFlow as JaxConvFlow
from bert_vits2_tpu.nn.wavenet import WN as JaxWN
from bert_vits2_tpu_torch.compat.params import (
    from_jax_dur_disc_params,
    from_jax_mpd_params,
    from_jax_params,
)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.discriminators import (
    DurationDiscriminator,
    MultiPeriodDiscriminator,
)
from bert_vits2_tpu_torch.ops import noise
from test_torch_modules import _cf, _err, _mask, _t, random_synth_params, random_tree
from torch_one_thread import one_torch_thread_except

ATOL = 1e-5
# the logdet bound of test_conv_flow_forward holds in torch's default
# summation order (1.049e-5 of 1e-5 with one thread)
one_thread_but_conv_flow = one_torch_thread_except("test_conv_flow_forward")
TINY = dict(
    n_vocab=20, bert_dim=16, ja_bert_dim=16, spec_channels=33, segment_size=8,
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=3, kernel_size=3, p_dropout=0.1, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4),
    upsample_initial_channel=16, upsample_kernel_sizes=(8, 8), n_speakers=4,
    gin_channels=8, n_flow_layer=2, n_layers_trans_flow=3,
)
MPD = dict(periods=(2, 3), p_channels=(8, 16),
           s_specs=((8, 15, 1, 1, 7), (16, 41, 4, 4, 20), (16, 5, 1, 1, 2)))
DD = dict(in_channels=8, filter_channels=16, kernel_size=3, p_dropout=0.1,
          gin_channels=8)


class NoiseTape:
    """The numbers both packages draw: the k-th draw of a run is a numpy
    array from the seed (seed, k), normal or uniform as asked."""

    def __init__(self, seed):
        self.seed, self.k = seed, 0

    def draw(self, shape, uniform=False):
        rng = np.random.default_rng([self.seed, self.k])
        self.k += 1
        a = rng.uniform(size=shape) if uniform else rng.normal(size=shape)
        return a.astype(np.float32)


def patch_noise(monkeypatch, seed, keep_layout=()):
    """Feed the JAX package and the port one tape each, with the same seed.
    The port's 3-D draws are [b, c, t] where the JAX package's are
    [b, t, c], except the draws whose index is in `keep_layout` (the MAS
    noise [b, t_y, t_x]). A normal draw asked for in a dtype (the
    posterior's bf16 noise) is rounded to it on both sides."""
    jax_tape, port_tape = NoiseTape(seed), NoiseTape(seed)
    real = {"normal": jax.random.normal, "uniform": jax.random.uniform}

    def fake(name):
        def draw(key, shape=(), *args, **kwargs):
            # flax re-runs parameter initializers (all in nn/conv.py) to
            # check shapes during apply: those calls are not noise
            if sys._getframe(1).f_code.co_filename.endswith("conv.py"):
                return real[name](key, shape, *args, **kwargs)
            a = jnp.asarray(jax_tape.draw(shape, uniform=name == "uniform"))
            dtype = args[0] if args else kwargs.get("dtype")
            return a if name == "uniform" or dtype is None else a.astype(dtype)
        return draw

    monkeypatch.setattr(jax.random, "normal", fake("normal"))
    monkeypatch.setattr(jax.random, "uniform", fake("uniform"))

    def randn(shape, generator, device, dtype=torch.float32, batch_axis=0):
        if len(shape) == 3 and port_tape.k not in keep_layout:
            b, c, t = shape
            return _t(port_tape.draw((b, t, c)).transpose(0, 2, 1).copy()).to(dtype)
        return _t(port_tape.draw(tuple(shape))).to(dtype)

    monkeypatch.setattr(noise, "randn", randn)
    monkeypatch.setattr(
        noise, "rand",
        lambda shape, generator, device, batch_axis=0: _t(
            port_tape.draw(tuple(shape), uniform=True)))


def build_pair(seed):
    """The JAX Synthesizer, random parameters for it, and the port in
    eval() mode loaded with them."""
    jax_model = JaxSynthesizer(JaxModelConfig(**TINY))
    params = random_synth_params(jax_model, seed=seed, bert_dim=16)
    port = build_synthesizer(ModelConfig(**TINY), device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    return jax_model, params, port


def build_discriminators(seed):
    """(JAX MPD, params, port MPD), (JAX duration D, params, port) with
    random parameters."""
    jmpd, jdd = JaxMPD(**MPD), JaxDurationDiscriminator(**DD)
    wav = jnp.zeros((1, 128))
    p_d = random_tree(jax.eval_shape(
        lambda: jmpd.init(jax.random.key(0), wav, wav))["params"], seed)
    ones = jnp.ones((1, 8, 1))
    p_dd = random_tree(jax.eval_shape(lambda: jdd.init(
        jax.random.key(0), jnp.zeros((1, 8, 8)), jnp.ones((1, 8)), ones, ones,
        g=jnp.zeros((1, 8))))["params"], seed + 1)
    mpd = MultiPeriodDiscriminator(**MPD).eval()
    mpd.load_state_dict(from_jax_mpd_params(p_d, MPD["periods"]), strict=True)
    dd = DurationDiscriminator(**DD).eval()
    dd.load_state_dict(from_jax_dur_disc_params(p_dd), strict=True)
    return (jmpd, p_d, mpd), (jdd, p_dd, dd)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=10)


@pytest.fixture(scope="module")
def discs():
    return build_discriminators(seed=20)


def _apply(jax_model, params, fn, *args):
    return jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, method=fn, rngs={"noise": jax.random.key(0)}))(
        params, *args)


def test_wn(pair):
    """The posterior encoder's 16-layer WN with speaker conditioning."""
    _, params, port = pair
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 8)).astype(np.float32)
    m = _mask([24, 15], 24)
    g = rng.normal(size=(2, 8)).astype(np.float32)
    wn = JaxWN(8, 5, 1, 16, gin_channels=8)
    want = jax.jit(lambda p, x, m, g: wn.apply({"params": p}, x, m, g=g))(
        params["enc_q"]["enc"], x, m, g)
    with torch.no_grad():
        got = port.enc_q.enc(_cf(x), _t(m[:, None]), g=_t(g))
    assert _err(got, want, m) <= ATOL


def test_posterior_encoder(pair, monkeypatch):
    jax_model, params, port = pair
    patch_noise(monkeypatch, seed=1)
    rng = np.random.default_rng(1)
    # std 0.3: at unit variance the random weights give |z| ~ 10 through
    # exp(logs_q), and 1e-5 absolute is then below fp32 resolution
    y = (0.3 * rng.normal(size=(2, 24, 33))).astype(np.float32)
    lens, sid = np.asarray([24, 17]), np.asarray([0, 3])

    def fn(mod, y, lens, sid):
        return mod.enc_q(y, lens, g=mod._speaker(sid, None))

    want = _apply(jax_model, params, fn, y, lens, sid)
    with torch.no_grad():
        got = port.enc_q(_cf(y), _t(lens), g=port.emb_g(_t(sid)))
    m = _mask(lens, 24)
    for gt, wt in zip(got[:3], want[:3]):  # z, m_q, logs_q
        assert _err(gt, wt, m) <= ATOL
    assert np.array_equal(got[3][:, 0].numpy(), np.asarray(want[3]))


def test_flow_forward_and_round_trip(pair):
    """The flow forward against JAX, and reverse(forward(z)) == z."""
    jax_model, params, port = pair
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 24, 8)).astype(np.float32)
    m = _mask([24, 19], 24)
    sid = np.asarray([1, 2])

    def fn(mod, z, m, sid):
        return mod.flow(z, m, g=mod._speaker(sid, None))

    want = _apply(jax_model, params, fn, z, m, sid)
    with torch.no_grad():
        g = port.emb_g(_t(sid))
        got = port.flow(_cf(z), _t(m[:, None]), g=g)
        back = port.flow(got, _t(m[:, None]), g=g, reverse=True)
    assert _err(got, want, m) <= ATOL
    assert _err(back, z, m) <= ATOL
    coupling = port.flow.flows[0]
    _, logdet = coupling(_cf(z), _t(m[:, None]), g=g)
    assert logdet.shape == (2,) and logdet.abs().max() == 0  # volume-preserving


def test_conv_flow_forward(pair):
    """The spline coupling forward with its log-determinant, and its
    round trip through the inverse spline (1e-4: the inverse solves a
    quadratic in fp32)."""
    _, params, port = pair
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 2)).astype(np.float32)
    g = (0.5 * rng.normal(size=(2, 9, 8))).astype(np.float32)
    m = _mask([9, 6], 9)
    cf = JaxConvFlow(2, 8, 3, n_layers=3)
    want, want_ld = jax.jit(lambda p, x, m, g: cf.apply({"params": p}, x, m, g=g))(
        params["sdp"]["flows_0"], x, m, g)
    flow = port.sdp.flows[1]
    with torch.no_grad():
        got, ld = flow(_cf(x), _t(m[:, None]), g=_cf(g))
        back = flow(got, _t(m[:, None]), g=_cf(g), reverse=True)
    assert _err(got, want, m) <= ATOL
    assert np.abs(ld.numpy() - np.asarray(want_ld)).max() <= ATOL
    assert _err(back, x, m) <= 1e-4


def test_sdp_nll(pair, monkeypatch):
    jax_model, params, port = pair
    patch_noise(monkeypatch, seed=4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    m = _mask([9, 6], 9)
    w = (rng.integers(1, 5, size=(2, 9, 1)) * m[..., None]).astype(np.float32)
    sid = np.asarray([3, 0])

    def fn(mod, x, m, w, sid):
        return mod.sdp(x, m, w=w, g=mod._speaker(sid, None))

    want = np.asarray(_apply(jax_model, params, fn, x, m, w, sid))
    with torch.no_grad():
        got = port.sdp.nll(_cf(x), _t(m[:, None]), _cf(w),
                           g=port.emb_g(_t(sid))).numpy()
    assert got.shape == want.shape == (2,)
    assert (np.abs(got - want) / np.abs(want)).max() <= 1e-5


def test_sdp_and_dp_detach_their_inputs(pair):
    """The duration losses train the predictors, not the text encoder."""
    _, _, port = pair
    x = torch.randn(1, 8, 9, requires_grad=True)
    g = torch.randn(1, 8, requires_grad=True)
    m = torch.ones(1, 1, 9)
    w = torch.ones(1, 1, 9)
    (port.sdp.nll(x, m, w, g=g).sum() + port.dp(x, m, g=g).sum()
     + port.sdp.reverse(x, m, torch.zeros(1, 2, 9), g=g).sum()).backward()
    assert x.grad is None and g.grad is None
    assert port.sdp.pre.weight.grad.abs().max() > 0
    port.zero_grad()


@pytest.mark.parametrize("t", [96, 101])
def test_multi_period_discriminator(discs, t):
    """Logits and every feature map; t = 101 is a multiple of neither
    period, so both period discriminators reflect-pad."""
    (jmpd, p_d, mpd), _ = discs
    rng = np.random.default_rng(t)
    y, y_hat = (rng.uniform(-0.5, 0.5, size=(2, t)).astype(np.float32)
                for _ in range(2))
    want = jax.jit(lambda p, a, b: jmpd.apply({"params": p}, a, b))(p_d, y, y_hat)
    with torch.no_grad():
        got = mpd(_t(y), _t(y_hat))
    for gl, wl in zip(got[0] + got[1], want[0] + want[1]):  # logits [b, n]
        assert np.abs(gl.numpy() - np.asarray(wl)).max() <= ATOL
    n_maps = 0
    for gd, wd in zip(got[2] + got[3], want[2] + want[3]):
        assert len(gd) == len(wd)
        for gm, wm in zip(gd, wd):  # [b, c, t(, p)] against [b, t(, p), c]
            gm = gm.numpy().transpose((0, 2, 1) if gm.dim() == 3 else (0, 2, 3, 1))
            assert np.abs(gm - np.asarray(wm)).max() <= ATOL
            n_maps += 1
    assert n_maps == 2 * (4 + 4 + 4)


def test_duration_discriminator(discs):
    """Conv stack and bidirectional LSTM (torch's fused gates against the
    JAX cell's per-gate kernels)."""
    _, (jdd, p_dd, dd) = discs
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 8)).astype(np.float32)
    m = _mask([9, 6], 9)
    dur_r, dur_hat = (rng.normal(size=(2, 9, 1)).astype(np.float32)
                      for _ in range(2))
    g = rng.normal(size=(2, 8)).astype(np.float32)
    want = jax.jit(lambda p, *a: jdd.apply({"params": p}, *a[:4], g=a[4]))(
        p_dd, x, m, dur_r, dur_hat, g)
    with torch.no_grad():
        got = dd(_cf(x), _t(m[:, None]), _cf(dur_r), _cf(dur_hat), g=_t(g))
    for gp, wp in zip(got, want):  # both [b, t, 1]
        assert gp.shape == wp.shape
        assert np.abs(gp.numpy() - np.asarray(wp)).max() <= ATOL
    xg = _cf(x).requires_grad_(True)
    sum(p.sum() for p in dd(xg, _t(m[:, None]), _cf(dur_r), _cf(dur_hat))).backward()
    assert xg.grad is None  # x is detached
    dd.zero_grad()
