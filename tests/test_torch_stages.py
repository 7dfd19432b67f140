"""PyTorch port, the six inference stages (`compat/stages.py`) and the
kernels' custom ops (`ops/library.py`), on the CPU.

One random parameter tree (every leaf random, the zero-initialized flow
`post` and SDP `proj` convs included) in the tiny configuration of
tests/test_stages.py (BERT width 16 for all three inputs), converted with
`from_jax_params`. The JAX package's stage values come from
`tests/goldens/stages.npz` (`tests/goldens/make_stages.py`: its
`make_stages` / `run_stages`, jitted, matmul precision "highest"), so this
file compiles nothing with JAX.

Bounds: each stage against the JAX stage on the same weights and inputs,
max-abs-err <= 1e-5 on valid positions; `run_stages` against the port's
`Synthesizer.infer` and the JAX `run_stages`: equal lengths, waves within
1e-5. The `.pt2` programs and the custom ops' CPU implementations run the
same plain functions as the live modules: equal outputs.
"""

import os

import numpy as np
import pytest
import torch

import golden_values
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.utils import flops as jax_flops
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.compat.stages import (
    STAGES,
    export_stages,
    load_stages,
    make_stages,
    run_stages,
    stage_inputs,
)
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.generator import ResBlock1
from bert_vits2_tpu_torch.ops import attention, mrf
from bert_vits2_tpu_torch.ops.library import plain_functions
from bert_vits2_tpu_torch.utils import flops
from test_torch_modules import random_synth_params
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens", "stages.npz")
SCRIPT = "python tests/goldens/make_stages.py"
ATOL = 1e-5

# tests/test_stages.py:18-25, the Japanese BERT input 16 wide like the others
CFG = dict(
    n_vocab=40, bert_dim=16, ja_bert_dim=16, spec_channels=33, segment_size=8,
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=2, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    upsample_rates=(4, 4), upsample_initial_channel=16,
    upsample_kernel_sizes=(8, 8), n_speakers=4, gin_channels=8,
    n_layers_trans_flow=2,
)
SEED = 31
B, T_X, X_LENS = 2, 12, (12, 9)
MAX_FRAMES, Y_LENS = 64, (64, 41)
# run_stages at zero noise, both predictors mixed
RUN_KNOBS = dict(noise_scale=0.0, noise_scale_w=0.0, sdp_ratio=0.5, length_scale=1.0)


def reference_inputs() -> dict:
    """The stages' inputs, numpy, in the JAX package's layout ([b, t, c])."""
    rng = np.random.default_rng(5)
    d = CFG["inter_channels"]

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return dict(
        x=rng.integers(1, CFG["n_vocab"], (B, T_X)).astype(np.int32),
        x_lengths=np.asarray(X_LENS, np.int32),
        sid=np.asarray([1, 3], np.int32),
        tone=rng.integers(0, 12, (B, T_X)).astype(np.int32),
        language=rng.integers(0, 3, (B, T_X)).astype(np.int32),
        bert=normal(B, T_X, 16, scale=0.5),
        ja_bert=normal(B, T_X, 16, scale=0.5),
        en_bert=normal(B, T_X, 16, scale=0.5),
        # the SDP's noise, scaled: std 0.3, as tests/test_torch_modules.py
        # draws it (at 0.8 the inverse spline leaves each framework's own
        # fp32 result ~1e-5 from a float64 run)
        z_sdp=normal(B, T_X, 2, scale=0.3),
        z_p=normal(B, MAX_FRAMES, d),
        y_lengths=np.asarray(Y_LENS, np.int32),
        z_dec=normal(B, MAX_FRAMES, d),
    )


def params_and_inputs():
    params = random_synth_params(JaxSynthesizer(JaxModelConfig(**CFG)), SEED, bert_dim=16)
    return params, reference_inputs()


def fingerprint(params, inputs):
    return golden_values.fingerprint(params, inputs, CFG, RUN_KNOBS, MAX_FRAMES)


@pytest.fixture(scope="module")
def setup():
    params, inp = params_and_inputs()
    want = golden_values.load(GOLDEN, fingerprint(params, inp), SCRIPT)
    model = build_synthesizer(ModelConfig(**CFG), device="cpu")
    res = model.load_state_dict(from_jax_params(params), strict=False)
    # at 2 layers the speaker conditioning (before layer 2) never runs: the
    # JAX modules have no parameters for it, the port's (the reference's
    # layout) keep their init
    assert not res.unexpected_keys
    assert res.missing_keys and all(".spk_emb_linear." in k for k in res.missing_keys)
    return model, make_stages(model), inp, want


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cf(a):
    """[b, t, c] numpy -> [b, c, t] tensor."""
    return _t(np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1)))


def _mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def _text(inp):
    """The text inputs of infer / run_stages as tensors."""
    ints = {k: _t(inp[k]).long() for k in ("x", "x_lengths", "sid", "tone", "language")}
    return {**ints, **{k: _t(inp[k]) for k in ("bert", "ja_bert", "en_bert")}}


def _stage_io(stage, inp, want):
    """(port stage arguments, JAX outputs [b, t, c] or [b, t], valid-position
    masks [b, t]) of one stage; downstream stages take the JAX stages'
    outputs, so each stage is held alone."""
    x_mask, y_mask = _mask(X_LENS, T_X), _mask(Y_LENS, MAX_FRAMES)
    g = _t(want["g"])
    hidden = (_cf(want["x_h"]), _t(want["x_mask"])[:, None, :], g)
    if stage == "emb":
        return (_t(inp["sid"]).long(),), [want["g"]], [None]
    if stage == "enc_p":
        t = _text(inp)
        args = (t["x"], t["x_lengths"], t["tone"], t["language"], t["bert"],
                t["ja_bert"], t["en_bert"], g)
        return args, [want[k] for k in ("x_h", "m_p", "logs_p", "x_mask")], [x_mask] * 4
    if stage == "sdp":
        return (*hidden, 1.0, None, _cf(inp["z_sdp"])), [want["logw_sdp"]], [x_mask]
    if stage == "dp":
        return hidden, [want["logw_dp"]], [x_mask]
    ym = _t(y_mask)[:, None, :]
    if stage == "flow":
        return (_cf(inp["z_p"]), ym, g), [want["z"]], [y_mask]
    hop = int(np.prod(CFG["upsample_rates"]))
    return (_cf(inp["z_dec"]), g, ym), [want["wave"]], [np.repeat(y_mask, hop, axis=1)]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(setup, stage):
    """Each port stage (make_stages) against the JAX make_stages stage on the
    same weights and inputs: max-abs-err <= 1e-5 on valid positions (the
    sdp with given noise here, at zero noise in the run_stages test)."""
    _, stages, inp, want = setup
    args, wants, masks = _stage_io(stage, inp, want)
    got = stages[stage](*args)
    got = got if isinstance(got, tuple) else (got,)
    for i, (o, w, m) in enumerate(zip(got, wants, masks)):
        o = o.numpy()
        if o.ndim == 3:  # [b, c, t] -> the JAX layout
            o = o[:, 0] if w.ndim == 2 else o.transpose(0, 2, 1)
        assert o.shape == w.shape, (stage, i, o.shape, w.shape)
        err = np.abs(o - w) if m is None else np.abs(o - w)[m.astype(bool)]
        assert err.max() <= ATOL, (stage, i, err.max())


def test_run_stages_matches_jax(setup):
    """run_stages at zero noise against the JAX run_stages (both predictors
    mixed): equal lengths, waves within 1e-5."""
    _, stages, inp, want = setup
    wave, y_len = run_stages(stages, **_text(inp), max_frames=MAX_FRAMES, **RUN_KNOBS)
    np.testing.assert_array_equal(y_len.numpy(), want["run_y_lengths"])
    assert np.abs(wave.numpy() - want["run_wave"]).max() <= ATOL


@pytest.mark.parametrize("noise", ["generator", "given", "zero"])
def test_run_stages_matches_infer(setup, noise):
    """run_stages against the port's own Synthesizer.infer on the same
    inputs and noise (drawn from one seeded generator in infer's order,
    given as z_in / eps, or zero): equal lengths, waves within 1e-5."""
    model, stages, inp, _ = setup
    kw = dict(max_frames=MAX_FRAMES, sdp_ratio=0.3, **_text(inp))
    if noise == "given":
        kw.update(z_in=_t(inp["z_sdp"]), eps=_t(inp["z_p"]))
    elif noise == "zero":
        kw.update(noise_scale=0.0, noise_scale_w=0.0)

    def gen():
        return torch.Generator().manual_seed(11)

    with torch.inference_mode():
        want, _, _, y_want = model.infer(generator=gen(),
                                         mrf_packed=model.dec.pack_mrf(), **kw)
    wave, y_len = run_stages(stages, generator=gen(), **kw)
    assert torch.equal(y_len, y_want)
    assert (wave - want).abs().max().item() <= ATOL


def test_pt2_round_trip(setup, tmp_path):
    """export_stages on the CPU, then each program loaded by torch.export.load
    gives the live stage's outputs; enc_p and the flow hold K1's op and the
    decoder K2's (the tiny model's C = 8 vocoder stage), so loaded on the
    CPU they run the plain versions."""
    model, stages, _, _ = setup
    paths = export_stages(model, str(tmp_path), t_x=T_X, max_frames=MAX_FRAMES, batch=B)
    assert set(paths) == set(STAGES)
    assert os.path.isfile(tmp_path / "manifest.json")
    loaded = load_stages(str(tmp_path))
    ops = {name: {str(n.target) for n in loaded[name].module.graph.nodes
                  if n.op == "call_function"} for name in paths}
    assert "bv2.banded_attn_fwd.default" in ops["enc_p"] & ops["flow"]
    assert "bv2.mrf_fwd.default" in ops["dec"]
    text = _text(reference_inputs())
    g = torch.Generator().manual_seed(2)
    sid = text.pop("sid")
    emb = stages["emb"](sid)
    hidden = stages["enc_p"](*text.values(), emb)
    y_mask = _t(_mask(Y_LENS, MAX_FRAMES))[:, None, :]
    d = model.cfg.inter_channels
    args = {"emb": (sid,), "enc_p": (*text.values(), emb),
            "sdp": (hidden[0], hidden[3], emb, torch.full((B,), 0.8),
                    torch.randn(B, 2, T_X, generator=g)),
            "dp": (hidden[0], hidden[3], emb),
            "flow": (torch.randn(B, d, MAX_FRAMES, generator=g), y_mask, emb),
            "dec": (torch.randn(B, d, MAX_FRAMES, generator=g), emb, y_mask)}
    assert {k: [tuple(a.shape) for a in v] for k, v in args.items()} == {
        k: [tuple(a.shape) for a in v] for k, v in stage_inputs(
            model.cfg, T_X, MAX_FRAMES, B).items()}
    for name in STAGES:
        a = args[name]
        want = stages[name](*a) if name != "sdp" else stages["sdp"](*a[:4], z=a[4])
        got = loaded[name](*a)
        for w, o in zip(*(v if isinstance(v, tuple) else (v,) for v in (want, got))):
            assert torch.equal(w, o), name


def _attention_args(dtype):
    g = torch.Generator().manual_seed(0)
    b, h, t, d, w = 2, 2, 20, 8, 4
    q, k, v = (torch.randn(b, h, t, d, generator=g).to(dtype) for _ in range(3))
    mask = torch.ones(b, t)
    mask[1, 13:] = 0
    ek, ev = (torch.randn(2 * w + 1, d, generator=g).to(dtype) for _ in range(2))
    return (q, k, v, mask, ek, ev), w


@pytest.mark.parametrize("name", ["banded_attn_fwd", "banded_attn_fwd_bf16",
                                  "banded_attn_wide_fwd", "banded_attn_wide_fwd_bf16",
                                  "mrf_fwd", "mrf_fwd_bf16"])
def test_custom_op_cpu_is_the_plain_version(name):
    """Each bv2 op's CPU implementation equals its kernel's plain version,
    and the wrappers reach it: banded_rel_self_attention / fused_mrf on the
    CPU go through the op of their dtype and shape, and inside
    plain_functions() they call the plain version directly (equal values,
    no op in a trace)."""
    op = getattr(torch.ops.bv2, name)
    dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
    if name.startswith("banded"):
        tensors, w = _attention_args(dtype)
        want = attention.banded_attention_plain(*tensors, w)
        got = op(*tensors, w)
        via_wrapper = lambda *a: attention.banded_rel_self_attention(*a, w)  # noqa: E731
    else:
        torch.manual_seed(0)
        blocks = [ResBlock1(16, k, (1, 3, 5)) for k in (3, 7)]
        weights = mrf.prepare_mrf_weights(blocks, dtype)
        x = torch.randn(2, 16, 40).to(dtype)
        m = torch.ones(2, 40, dtype=dtype)
        m[1, 29:] = 0
        tensors = (x, m)
        want = mrf.fused_mrf_plain(x, m, weights)
        got = op(x, m, *weights.op_args)
        via_wrapper = lambda *a: mrf.fused_mrf(*a, weights)  # noqa: E731
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.no_grad():
        if "wide" not in name:  # the shapes above take the tensor-core ops
            assert torch.equal(via_wrapper(*tensors), want)
        with plain_functions():
            assert torch.equal(via_wrapper(*tensors), want)

    class Probe(torch.nn.Module):
        def forward(self, *a):
            return via_wrapper(*a)

    if "wide" not in name:
        for plain, has_op in ((False, True), (True, False)):
            with torch.no_grad():
                if plain:
                    with plain_functions():
                        prog = torch.export.export(Probe(), tensors, strict=False)
                else:
                    prog = torch.export.export(Probe(), tensors, strict=False)
            targets = {str(n.target) for n in prog.graph.nodes}
            assert (f"bv2.{name}.default" in targets) == has_op, targets


@pytest.mark.parametrize("wrapper", ["banded_rel_self_attention", "fused_mrf"])
def test_plain_functions_refuse_tensors_off_the_cpu(wrapper):
    """Inside plain_functions() a wrapper given tensors off the CPU raises
    (here on the meta device; on the card the same branch): the context
    serves the exporter's CPU trace and never puts the plain version in a
    kernel's place. Outside it the same call gets past that check."""
    if wrapper == "banded_rel_self_attention":
        tensors, w = _attention_args(torch.float32)
        call = lambda *a: attention.banded_rel_self_attention(*a, w)  # noqa: E731
    else:
        blocks = [ResBlock1(16, k, (1, 3, 5)) for k in (3, 7)]
        weights = mrf.prepare_mrf_weights(blocks, torch.float32)
        tensors = (torch.zeros(2, 16, 40), torch.ones(2, 40))
        call = lambda *a: mrf.fused_mrf(*a, weights)  # noqa: E731
    meta = tuple(t.to("meta") for t in tensors)
    with torch.no_grad(), plain_functions():
        with pytest.raises(RuntimeError, match="plain_functions"):
            call(*meta)
    with torch.no_grad():
        with pytest.raises(Exception) as outside:
            call(*meta)  # no kernel takes meta tensors, for another reason
    assert "plain_functions" not in str(outside.value)


@pytest.mark.parametrize("which", ["v23", "tiny"])
def test_flops_copy_matches_jax(which):
    """utils/flops.py is the JAX package's model: equal per-stage FLOPs for
    the default V2.3 config and the tiny one."""
    cfg, jcfg = ((ModelConfig(), JaxModelConfig()) if which == "v23"
                 else (ModelConfig(**CFG), JaxModelConfig(**CFG)))
    for b, t_x, frames in ((1, 128, 1024), (8, 64, 384)):
        got = flops.infer_stage_flops(cfg, b, t_x, frames)
        assert got == jax_flops.infer_stage_flops(jcfg, b, t_x, frames)
        assert set(got) == {"emb", "enc_p", "sdp", "dp", "align", "flow", "dec"}
        assert flops.analytic_infer_flops(cfg, b, t_x, frames) == \
            jax_flops.analytic_infer_flops(jcfg, b, t_x, frames)
