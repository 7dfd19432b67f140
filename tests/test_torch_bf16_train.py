"""PyTorch port, bf16 training (`train_compute_dtype="bfloat16"`,
`bf16_run`) against the JAX package on the CPU.

- The plain bf16 training direction of the attention (K1's train mode with
  m, l and the hash dropout; B5 and B6 through `BandedAttentionFn`, whose
  CPU backward is `banded_attention_bwd_plain_bf16`) against the TPU
  kernels in interpret mode and their `jax.vjp` on bf16 inputs: the plain
  versions are what the card's bf16 kernels are held to
  (tests/test_torch_kernels_cuda.py), so each must round where the TPU
  kernels round. The one known difference: B5 takes delta = g . out (the
  bf16 output) where `_attn_bwd_q_kernel` sums its own fp32 rows, as B6
  already does on both sides; it moves dq and dek by less than an ulp.
- Each bf16 stage of the training forward against its JAX module on the
  same bf16 inputs, from one random parameter tree
  (tests/test_torch_modules.py), the gradients of a scalar against the
  float32 master parameters: the posterior encoder, the flow (dropout off),
  the decoder with bf16 g, the multi-period discriminator. Each output's
  and each stage's gradients' error against fp32 (relative, in L2) within
  BF16_ERR_FACTOR times the JAX package's own bf16 error on the same
  inputs, fp32 being the port's modules on the same values (held to the
  JAX fp32 modules within 1e-5 by tests/test_torch_train_modules.py). The
  same test pins ROADMAP §C R.6: the JAX decoder, given the float32 g that
  the JAX forward passes it, computes `cond` in float32; the port's
  decoder, given bf16 g, stays bf16.
- The port's real bf16 step (every dropout 0, the noise tape of
  tests/test_torch_train_modules.py) against a JAX bf16 step composed as
  tests/test_torch_train_step.py composes the fp32 one, with the decoder
  taking g in bf16 (R.6), the multi-period discriminator on bf16 waves and
  global-norm clipping, without the duration discriminator (which bf16_run
  leaves in fp32). The losses, the grad norms and the updated parameters,
  each group as one vector: the port's bf16 no further from JAX's bf16
  than JAX's bf16 lies from fp32, fp32 being the port's fp32 step on the
  same weights (held to the JAX fp32 step within 1e-4 by
  tests/test_torch_train_step.py).
- The JAX values of the stages and of the step are read from
  tests/goldens/bf16_train.npz, which tests/goldens/make_bf16_train.py
  computes from this file's `reference_inputs` (their fingerprint is
  checked first): the JAX graphs of the bf16 step and stages take ~3 min
  to trace and compile here, which the test suite's time limit cannot
  spare.
- The step's global-norm clipping against `optax.clip_by_global_norm` +
  `adamw`, below, at and above the limit, with a frozen group.

Bounds in bf16 ulps are ulps of the largest reference entry (bf16 keeps 8
significant bits: an ulp is 2**-7 of the leading power of two).
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.ops import attention_pallas as jap
from bert_vits2_tpu.train import step as jax_step
from bert_vits2_tpu_torch.compat.params import from_jax_mpd_params, from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.discriminators import MultiPeriodDiscriminator
from bert_vits2_tpu_torch.ops.attention import (
    banded_attention_fwd_train,
    banded_rel_self_attention,
)
from bert_vits2_tpu_torch.train import (
    DataConfig,
    Models,
    TrainConfig,
    init_train_state,
    make_train_step,
    step as port_step,
)
import golden_values
from test_torch_modules import _cf, _mask, _t, random_synth_params
from test_torch_train_modules import MPD, TINY, build_discriminators, patch_noise
from test_torch_train_ops import _Tiny
from test_torch_train_step import DATA, LR, MAS_DRAW, _no_dropout, make_batch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
JBF16 = jnp.bfloat16
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "bf16_train.npz")
NOISE_SEED = 6
# the plain bf16 training direction against the TPU kernels: the output
# rounds at the same points (P to bf16 for P.V, the output), a reordered
# fp32 sum can flip a last rounding; the gradients round ds and p*ks the
# same way, and B5's delta moves dq and dek by < 1 ulp: 2 ulps each
TRAIN_ULPS = 2
STATS_REL = 1e-5  # m, l: fp32 row max and sum of fp32 scores, another order
# the bf16 stages' and step's error against fp32, relative to the JAX
# package's own: eager PyTorch rounds each op's output to bf16, where XLA's
# CPU fusions keep fp32 between the ops of a fusion and round once, so the
# port's bf16 carries up to ~2x JAX's rounding error through a deep stack
# (16 WN layers, 6 attention layers and their LayerNorms)
BF16_ERR_FACTOR = 2.0


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _bf16(a) -> np.ndarray:
    """float32 values rounded to bf16, as float32."""
    return np.asarray(jnp.asarray(a, JBF16).astype(jnp.float32))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_plain_bf16_train_direction_matches_pallas_kernels():
    """K1's train mode, B5 and B6 in their plain bf16 versions against the
    TPU kernels in interpret mode on bf16 q, k, v, ek, ev and g, with the
    hash dropout: out and the five gradients (valid rows) within TRAIN_ULPS
    bf16 ulps of the largest reference entry, m and l within STATS_REL."""
    b, h, t, d, w, lens = 2, 2, 24, 16, 4, [24, 13]
    p_drop, seed = 0.1, 12345
    rng = np.random.default_rng(21)
    q, k, v = (_bf16(rng.normal(size=(b, h, t, d))) for _ in range(3))
    q = _bf16(q / np.sqrt(d))
    ek, ev = (_bf16(rng.normal(size=(2 * w + 1, d)) / np.sqrt(d)) for _ in range(2))
    m = _mask(lens, t)
    go = _bf16(rng.normal(size=(b, h, t, d)) * m[:, None, :, None])
    seed_j = jnp.asarray([seed], jnp.int32)

    def kernel(q, k, v, ek, ev):
        return jap.banded_rel_self_attention(q, k, v, jnp.asarray(m), ek, ev, w,
                                             dropout_p=p_drop, dropout_seed=seed_j,
                                             interpret=True)

    ops = [jnp.asarray(a, JBF16) for a in (q, k, v, ek, ev)]
    want_out, vjp = jax.vjp(kernel, *ops)
    want_grads = vjp(jnp.asarray(go, JBF16))
    padded = jap._pad_inputs(*ops, w)[:5]
    _, want_m, want_l = jap._fwd_call(*padded[:3], jnp.asarray(m), *padded[3:], seed_j,
                                      w=w, p_drop=p_drop, stats=True, interpret=True)

    leaves = [torch.tensor(a).to(BF16).requires_grad_() for a in (q, k, v, ek, ev)]
    out = banded_rel_self_attention(*leaves[:3], _t(m), *leaves[3:], w, p_drop, seed)
    grads = torch.autograd.grad(out, leaves, _t(go).to(BF16))
    with torch.no_grad():
        _, got_m, got_l = banded_attention_fwd_train(
            *(x.detach() for x in leaves[:3]), _t(m), *(x.detach() for x in leaves[3:]),
            w, p_drop, seed)
    assert out.dtype == BF16 and all(g_.dtype == BF16 for g_ in grads)
    assert got_m.dtype == got_l.dtype == torch.float32

    valid = m.astype(bool)
    report = []
    for name, got, want in zip(("out", "dq", "dk", "dv", "dek", "dev"),
                               (out, *grads), (want_out, *want_grads)):
        got, want = _np(got), _np(want)
        if got.ndim == 4:  # valid rows
            got, want = (a.transpose(0, 2, 1, 3)[valid] for a in (got, want))
        ulps = np.abs(got - want).max() / _ulp(np.abs(want).max())
        report.append(f"{name} {ulps:.2f}")
        assert ulps <= TRAIN_ULPS, (name, ulps)
    for name, got, want in (("m", got_m, want_m), ("l", got_l, want_l)):
        got, want = _np(got).transpose(0, 2, 1)[valid], _np(want)[..., 0].transpose(
            0, 2, 1)[valid]
        rel = np.abs(got - want).max() / np.abs(want).max()
        report.append(f"{name} {rel:.1e}")
        assert rel <= STATS_REL, (name, rel)
    print("plain bf16 train direction vs TPU kernels (ulps; m, l relative): "
          + ", ".join(report))


def _stage_inputs(seed):
    """bf16-valued inputs of the stages ([b, t, c] layout) and the weights
    of the scalar whose gradients are compared."""
    rng = np.random.default_rng(seed)
    b, t, lens = 2, 24, [24, 17]
    m = _mask(lens, t)
    f = lambda *s: _bf16(rng.normal(size=s))  # noqa: E731
    return dict(
        y=_bf16(0.3 * rng.normal(size=(b, t, 33))), lens=np.asarray(lens), m=m,
        g=f(b, 8), z=f(b, t, 8), zd=f(b, 8, 8),
        wy=_bf16(rng.uniform(-0.5, 0.5, size=(b, 96))),
        wh=_bf16(rng.uniform(-0.5, 0.5, size=(b, 96))),
        r=[rng.normal(size=s).astype(np.float32)
           for s in ((b, t, 8), (b, t, 8), (b, t, 8), (b, 128))])


def reference_inputs():
    """The JAX Synthesizer (TINY, bf16 policy) and a random tree for it, the
    multi-period discriminator and a tree for it, the stage inputs and the
    step's batch: what tests/goldens/make_bf16_train.py computes the JAX
    values from."""
    jax_model = JaxSynthesizer(JaxModelConfig(**TINY, train_compute_dtype="bfloat16"))
    p_g = random_synth_params(jax_model, seed=30, bert_dim=16)
    (jmpd, p_d, _), _ = build_discriminators(seed=32)
    return jax_model, p_g, jmpd, p_d, _stage_inputs(7), make_batch()


def fingerprint(p_g, p_d, x, batch) -> np.ndarray:
    """Of every parameter and input value, the models' configs and the
    step's constants."""
    consts = [LR, NOISE_SEED, MAS_DRAW, TINY, MPD, DATA]
    return golden_values.fingerprint(p_g, p_d, x, batch, consts)


@pytest.fixture(scope="module")
def reference():
    """The inputs and trees, and the JAX package's values on them from
    tests/goldens/bf16_train.npz (written by tests/goldens/make_bf16_train.py
    from `reference_inputs`, whose fingerprint must match): the stages'
    outputs and gradients, the bf16 step's metrics and updated parameters."""
    jax_model, p_g, jmpd, p_d, x, batch = reference_inputs()
    want = golden_values.load(GOLDENS, fingerprint(p_g, p_d, x, batch),
                              "tests/goldens/make_bf16_train.py")
    return jax_model, p_g, jmpd, p_d, x, batch, lambda prefix: golden_values.pick(want, prefix)


def _port_models(p_g, p_d, dtype):
    """The port's Synthesizer (train_compute_dtype `dtype`) and
    multi-period discriminator loaded with the JAX trees."""
    synth = build_synthesizer(ModelConfig(**TINY, train_compute_dtype=dtype),
                              device="cpu")
    synth.load_state_dict(from_jax_params(p_g), strict=True)
    mpd = MultiPeriodDiscriminator(**MPD)
    mpd.load_state_dict(from_jax_mpd_params(p_d, MPD["periods"]), strict=True)
    return synth, mpd


def _port_stages(port, mpd, x, dtype, monkeypatch):
    """The stages on the port in `dtype`, their scalar's gradients against
    the float32 parameters -> (outputs [b, t, c], generator gradients by
    name, mpd outputs, mpd gradients by name)."""
    patch_noise(monkeypatch, seed=3)  # the posterior's eps, in its dtype
    port.eval().zero_grad()
    mpd.zero_grad()
    mt = _t(x["m"][:, None])
    g = _t(x["g"]).to(dtype)
    _, mq, lq, _ = port.enc_q(_cf(x["y"]).to(dtype), _t(x["lens"]), g=g)
    zf = port.flow(_cf(x["z"]).to(dtype), mt, g=g)
    wave = port.dec(_cf(x["zd"]).to(dtype), g=g)
    outs = (mq, lq, zf, wave)
    sum(torch.sum(o.float() * (_cf(r) * mt if o.dim() == 3 else _t(r)))
        for o, r in zip(outs, x["r"])).backward()
    rs, gs, fr, fg = mpd(_t(x["wy"]).to(dtype), _t(x["wh"]).to(dtype))
    (sum(torch.sum(a.float()) for a in rs + gs)
     + sum(torch.mean(a.float().abs()) for d in fr + fg for a in d)).backward()
    grads = lambda mod: {n: p.grad.clone() for n, p in mod.named_parameters()  # noqa: E731
                         if p.grad is not None}
    outs = tuple(o.transpose(1, 2) if o.dim() == 3 else o for o in outs)
    return outs, grads(port), tuple(rs + gs), grads(mpd)


def _rel(a, ref, valid=None) -> float:
    """|a - ref| / |ref| in L2, over the valid positions."""
    a, ref = _np(a), _np(ref)
    if valid is not None:
        a, ref = a[valid], ref[valid]
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def test_bf16_stages_match_jax_and_pin_r6(reference, monkeypatch):
    """enc_q (m_q, logs_q), the flow (dropout off; the fused attention's
    CPU path) and the decoder with bf16 g, and the multi-period
    discriminator, on bf16 inputs against the JAX modules, from float32
    parameters: outputs (valid positions) and the parameters' gradients of
    one scalar, each stage's error against fp32 in relative L2 within
    BF16_ERR_FACTOR times the JAX package's own bf16 error on the same
    inputs (fp32: the port's modules on the same values, which
    tests/test_torch_train_modules.py holds to the JAX fp32 modules within
    1e-5). R.6: the JAX decoder computes `cond` in float32 when given the
    forward's float32 g; the port's decoder output is bf16."""
    jax_model, p_g, jmpd, p_d, x, _, pick = reference
    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")  # the explicit bf16 backward
    outs, mouts = pick("stage_out/"), pick("stage_mpd_out/")
    want = ([outs[str(i)] for i in range(len(outs))], pick("stage_grad/"),
            [mouts[str(i)] for i in range(len(mouts))], pick("stage_mpd_grad/"))
    port, mpd = _port_models(p_g, p_d, "bfloat16")
    ref = _port_stages(port, mpd, x, torch.float32, monkeypatch)
    got = _port_stages(port, mpd, x, BF16, monkeypatch)
    assert all(_bf16(o).tobytes() == o.tobytes() for o in want[0])  # bf16 values
    assert all(o.dtype == BF16 for o in got[0] + got[2])  # R.6: the decoder stays bf16
    assert {p.dtype for p in port.parameters()} == {
        g.dtype for g in got[1].values()} == {torch.float32}

    valid = x["m"].astype(bool)
    report = []
    for i, name in enumerate(("m_q", "logs_q", "flow", "dec", *(
            f"mpd logits {j}" for j in range(len(got[2]))))):
        k, j = (0, i) if i < 4 else (2, i - 4)
        v = valid if got[k][j].dim() == 3 else None
        report.append((name, _rel(got[k][j], ref[k][j], v),
                       _rel(want[k][j], ref[k][j], v)))
    for k, prefixes in ((1, ("enc_q.", "flow.", "dec.")), (3, ("",))):
        for prefix in prefixes:
            names = [n for n in want[k] if n.startswith(prefix)]
            flat = lambda d: np.concatenate([_np(d[n]).ravel() for n in names])  # noqa: E731
            report.append((f"grads {prefix or 'mpd'}", _rel(flat(got[k]), flat(ref[k])),
                           _rel(flat(want[k]), flat(ref[k]))))
    print("bf16 stages, relative L2 error against fp32, port | JAX: " + "; ".join(
        f"{n} {a:.2e} | {b:.2e}" for n, a, b in report))
    for name, a, b in report:
        assert a <= BF16_ERR_FACTOR * b, (name, a, b)

    # R.6: what the JAX forward gives its decoder (bf16 z, float32 g)
    jwave, state = jax_model.apply(
        {"params": p_g}, jnp.asarray(x["zd"], JBF16), jnp.asarray(x["g"]),
        method=lambda mod, z, g: mod.dec(z, g=g), mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "cond")
    (cond,) = state["intermediates"]["dec"]["cond"]["__call__"]
    assert cond.dtype == jnp.float32 and jwave.dtype == jnp.float32


def _port_step(synth, mpd, batch, bf16, monkeypatch):
    """One real port step (dropout rates 0, the noise tape, no duration
    discriminator) -> (metrics, updated parameters of G and D by name)."""
    patch_noise(monkeypatch, seed=NOISE_SEED, keep_layout=(MAS_DRAW,))
    models = Models(synth, mpd, None, None)
    _no_dropout(synth, mpd)
    cfg = TrainConfig(learning_rate=LR, bf16_run=bf16)
    state = init_train_state(models, cfg)
    step = make_train_step(models, cfg, DataConfig(**DATA), TINY["segment_size"])
    state, metrics = step(state, {k: _t(v) for k, v in batch.items()}, None, LR)
    params = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (synth, mpd)]
    return {k: float(v) for k, v in metrics.items()}, params


def test_bf16_step_matches_jax_bf16_step(reference, monkeypatch):
    """The port's real bf16 step (train_compute_dtype "bfloat16",
    bf16_run, the fused attention's CPU path, no duration discriminator)
    against the JAX bf16 step composed above, from one random tree, batch
    and noise tape: the losses, the grad norms and the updated parameters,
    each group as one vector, no further from the JAX bf16 values than
    those lie from fp32 (the port's fp32 step on the same weights). The
    master parameters stay float32."""
    _, p_g, _, p_d, _, batch, pick = reference
    want = {k: float(v) for k, v in pick("step_metric/").items()}
    want_params = [pick("step_g/"), pick("step_d/")]
    monkeypatch.setenv("BV2_FUSED_ATTENTION_TRAIN", "1")
    synth, mpd = _port_models(p_g, p_d, "bfloat16")
    got, got_params = _port_step(synth, mpd, batch, True, monkeypatch)
    assert {p.dtype for p in synth.parameters()} == {torch.float32}
    synth, mpd = _port_models(p_g, p_d, "float32")
    ref, ref_params = _port_step(synth, mpd, batch, False, monkeypatch)
    assert set(got) == set(want) | {"learning_rate"}

    # each group as one vector: the losses' and the grad norms' relative
    # errors, and every updated parameter; a single scalar carries one
    # draw of rounding noise and can fall on either side
    def vec(metrics, prefix):
        return np.asarray([metrics[k] / ref[k] for k in sorted(want) if
                           k.startswith(prefix) and ref[k]])

    def flat(params):
        return np.concatenate([_np(d[n]).ravel() for d, w in zip(params, want_params)
                               for n in w])

    report = []
    for label, g_, w, r in (
            ("losses", vec(got, "loss/"), vec(want, "loss/"), 1.0),
            ("grad norms", vec(got, "grad_norm"), vec(want, "grad_norm"), 1.0),
            ("updated parameters", flat(got_params), flat(want_params),
             flat(ref_params))):
        scale = np.linalg.norm(r) if np.ndim(r) else np.sqrt(len(g_))
        r = np.ones_like(g_) if not np.ndim(r) else r
        report.append((label, float(np.linalg.norm(g_ - w) / scale),
                       float(np.linalg.norm(w - r) / scale)))
    print("bf16 step, relative L2: port vs JAX bf16 | JAX bf16 vs fp32: " + "; ".join(
        f"{n} {a:.2e} | {b:.2e}" for n, a, b in report) + "; each metric, port | JAX "
        "against fp32: " + ", ".join(f"{k} {abs(got[k] / ref[k] - 1):.1e} | "
                                     f"{abs(float(want[k]) / ref[k] - 1):.1e}"
                                     for k in sorted(want) if ref[k]))
    for name, a, b in report:
        assert a <= b, (name, a, b)


def test_clipping_matches_optax():
    """`bf16_run`'s global-norm clipping against `optax.clip_by_global_norm`
    + `adamw` (+ `masked(set_to_zero)` for a frozen group), the JAX
    package's `make_optimizer`, on one gradient tree scaled to a global
    norm below, at and above the limit: the returned norm is the unclipped
    one, the parameters agree to 1e-6 after each update, the frozen leaves
    do not move, and the gradients are clipped in place (the frozen ones
    too: their norm counts). Without bf16_run nothing is clipped."""
    rng = np.random.default_rng(8)
    clip = 0.5
    cfg_kw = dict(learning_rate=2e-4, bf16_run=True, grad_clip_g=clip,
                  freeze_zh_bert=True)
    jcfg = jax_step.TrainConfig(**cfg_kw)
    port = _Tiny()
    names = [n for n, _ in port.named_parameters()]
    values = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for n, p in port.named_parameters()}
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(_t(values[n]))

    def tree(flat):  # "enc_p.bert_proj.weight" -> nested dicts
        out = {}
        for n, v in flat.items():
            node = out
            *path, leaf = n.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
        return out

    params = tree(values)
    tx = jax_step.make_optimizer(jcfg, jcfg.grad_clip_g, jcfg.frozen_subtrees)
    opt_state = tx.init(params)
    tcfg = TrainConfig(**cfg_kw)
    opt = port_step.make_optimizer(tcfg, port, tcfg.frozen_subtrees, tcfg.grad_clip_g)
    assert opt.clip == clip
    unit = {n: rng.normal(size=values[n].shape).astype(np.float32) for n in names}
    norm1 = np.sqrt(sum(float(np.sum(u.astype(np.float64) ** 2)) for u in unit.values()))
    for lr, target in ((2e-4, 0.5 * clip), (1.5e-4, clip), (1e-4, 3.0 * clip)):
        grads = {n: (u * np.float32(target / norm1)).astype(np.float32)
                 for n, u in unit.items()}
        upd, opt_state = tx.update(
            tree(grads), jax_step._set_lr(opt_state, lr), params)
        params = optax.apply_updates(params, upd)
        # a loss whose gradient is `grads`: sum(p * G)
        loss = sum(torch.sum(p * _t(grads[n])) for n, p in port.named_parameters())
        norm = port_step._update(opt, loss, lr)
        want_norm = float(optax.global_norm(tree(grads)))
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        scale = 1.0 if want_norm < clip else clip / want_norm
        for n, p in port.named_parameters():
            assert np.abs(p.grad.numpy() - grads[n] * scale).max() <= 1e-6, n
            node = params
            for k in n.split("."):
                node = node[k]
            assert np.abs(p.detach().numpy() - np.asarray(node)).max() <= 1e-6, (n, target)
    for n, p in port.named_parameters():
        if n.startswith("enc_p.bert_proj."):
            assert np.array_equal(p.detach().numpy(), values[n])
    # without bf16_run the optimizer does not clip
    fp32 = port_step.make_optimizer(TrainConfig(grad_clip_g=clip), port)
    assert fp32.clip is None
