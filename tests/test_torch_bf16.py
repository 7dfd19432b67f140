"""PyTorch port, bf16 serving (`infer_compute_dtype="bfloat16"`) against the
JAX package on the CPU.

- K1's plain bf16 version against the TPU kernel `_attn_fwd_kernel` in
  interpret mode on bf16 inputs, and K2's against `fused_mrf` in interpret
  mode with bf16-packed weights: the plain versions are what the card's
  bf16 kernels are held to (tests/test_torch_kernels_cuda.py), so each
  must round where the TPU kernel rounds.
- `Synthesizer.infer` in bf16 against the JAX bf16 synthesis at zero noise,
  from one random parameter tree (tests/test_torch_modules.py): the
  lengths and the alignment exactly, the wave within the JAX package's own
  bf16 error. The JAX CPU path runs its ResBlocks and the XLA attention
  formula (softmax in bf16), so the two bf16 paths round at different
  points: the bound is relative, the port's bf16 wave no further from
  JAX's bf16 wave than that lies from JAX's fp32 wave.
- `load_tts_engine(compute_dtype=...)` for the V2.3 and the vits1-flow
  families: one `G_0.pth`, identical state_dicts in both dtypes, finite
  bf16 waves of the fp32 engine's lengths; an unknown dtype raises.

Bounds in bf16 ulps are ulps of the largest reference entry (bf16 keeps 8
significant bits: an ulp is 2**-7 of the leading power of two).
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from bert_vits2_tpu.models import ModelConfig as JaxModelConfig
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer
from bert_vits2_tpu.models.generator import ResBlock1 as JResBlock1
from bert_vits2_tpu.ops.attention_pallas import banded_rel_self_attention as j_banded
from bert_vits2_tpu.ops.mrf_pallas import fused_mrf as j_fused_mrf
from bert_vits2_tpu.ops.mrf_pallas import prepare_mrf_weights as j_prepare_mrf
from bert_vits2_tpu_torch.compat.params import from_jax_params
from bert_vits2_tpu_torch.config import ModelConfig
from bert_vits2_tpu_torch.infer import PreparedRequest, load_tts_engine
from bert_vits2_tpu_torch.models import build_synthesizer
from bert_vits2_tpu_torch.models.generator import ResBlock1
from bert_vits2_tpu_torch.ops.attention import banded_rel_self_attention
from bert_vits2_tpu_torch.ops.mrf import fused_mrf, prepare_mrf_weights
import golden_values
from test_torch_modules import TINY, random_synth_params
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16
KS = (3, 7, 11)
DS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
# K1: the same arithmetic as the TPU kernel; fp32 sums in another order
# can flip the last rounding of P (2**-9 of an entry) or of the output:
# within 2 ulps of the output.
K1_ULPS = 2
# K2: the TPU kernel's leaky-ReLU slope is 0.1 rounded to bf16 (0.10009765625,
# its bf16 arithmetic), the port's 0.1: 2**-10 of every negative
# activation, which with the fp32 sums in another order flips roundings in
# 18 chained convs; each flip is 1 ulp of an intermediate carried on by
# the later convs and residuals: within 4 ulps of the output.
K2_ULPS = 4


def _ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def _bf16(a) -> np.ndarray:
    """float32 values rounded to bf16, as float32 (the same values reach
    both frameworks)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _mask(lens, t):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


def test_k1_plain_bf16_matches_pallas_kernel():
    """K1's plain bf16 version against `_attn_fwd_kernel` in interpret mode
    (bf16 q, k, v, ek, ev and mask; t % 8 == 0 as it needs), valid rows."""
    b, h, t, d, w, lens = 2, 2, 24, 16, 4, [24, 13]
    rng = np.random.default_rng(11)
    q, k, v = (_bf16(rng.normal(size=(b, h, t, d))) for _ in range(3))
    q = _bf16(q / np.sqrt(d))
    ek, ev = (_bf16(rng.normal(size=(2 * w + 1, d)) / np.sqrt(d)) for _ in range(2))
    m = _mask(lens, t)
    args = (q, k, v, m, ek, ev)
    want = np.asarray(j_banded(*(jnp.asarray(a, jnp.bfloat16) for a in args), w,
                               interpret=True).astype(jnp.float32))
    with torch.inference_mode():
        got = banded_rel_self_attention(*(torch.tensor(a).to(BF16) for a in args), w)
    assert got.dtype == BF16
    valid = m.astype(bool)
    got, want = (a.transpose(0, 2, 1, 3)[valid] for a in (got.float().numpy(), want))
    err, bound = np.abs(got - want).max(), K1_ULPS * _ulp(np.abs(want).max())
    print(f"K1 bf16 plain vs TPU kernel: max_abs_err {err:.3e}, bound {bound:.3e}")
    assert err <= bound


class _JMRF(fnn.Module):
    ch: int

    @fnn.compact
    def __call__(self, x, x_mask):
        xs = None
        for j, (k, d) in enumerate(zip(KS, DS)):
            blk = JResBlock1(self.ch, k, d, time_fold=1, name=f"rb_{j}")
            xs = blk(x, x_mask) if xs is None else xs + blk(x, x_mask)
        return xs / len(KS)


def test_k2_plain_bf16_matches_pallas_kernel():
    """K2's plain bf16 version against `fused_mrf` in interpret mode with
    weights packed in bf16 (`prepare_mrf_weights(..., jnp.bfloat16)`: the
    weight-norm-resolved weights rounded, the biases fp32), bf16 x; unit-
    gain random convs, a ragged mask; valid positions, and the masked tail
    silent."""
    c, t, lens = 16, 256, [199]
    rng = np.random.default_rng(12)
    x = _bf16(rng.normal(size=(1, t, c)))
    m = _mask(lens, t)
    shapes = _JMRF(c).init(jax.random.key(0), x, m)["params"]

    def fill(path, a):
        if path[-1].key == "v":
            return (rng.normal(size=a.shape) / np.sqrt(a.shape[0] * c)).astype(np.float32)
        if path[-1].key == "g":
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    jblocks = [params[f"rb_{j}"] for j in range(3)]
    want = np.asarray(j_fused_mrf(jnp.asarray(x, jnp.bfloat16), jnp.asarray(m),
                                  j_prepare_mrf(jblocks, KS, DS, jnp.bfloat16), KS, DS,
                                  interpret=True).astype(jnp.float32))
    blocks = []
    for jb, k, d in zip(jblocks, KS, DS):
        blk = ResBlock1(c, k, d)
        blk.load_state_dict(from_jax_params(jb), strict=True)
        blocks.append(blk)
    wts = prepare_mrf_weights(blocks, BF16)
    assert wts.dtype == BF16 and wts.convs[0][0][0].dtype == BF16
    assert wts.convs[0][0][1].dtype == torch.float32  # biases stay fp32
    with torch.inference_mode():
        got = fused_mrf(torch.tensor(x.transpose(0, 2, 1)).to(BF16),
                        torch.tensor(m).to(BF16), wts)
    assert got.dtype == BF16
    got = got.float().numpy().transpose(0, 2, 1)
    valid = m.astype(bool)
    err, bound = np.abs(got - want)[valid].max(), K2_ULPS * _ulp(np.abs(want).max())
    print(f"K2 bf16 plain vs TPU kernel: max_abs_err {err:.3e}, bound {bound:.3e}")
    assert err <= bound
    assert np.abs(got[0, lens[0]:]).max() == 0.0


@pytest.fixture(scope="module")
def models():
    """One random parameter tree (the flow's post convs too) and the port's
    bf16 model loaded from it."""
    jax_cfg = JaxModelConfig(**TINY)
    params = random_synth_params(JaxSynthesizer(jax_cfg), seed=21)
    port = build_synthesizer(ModelConfig(**TINY, infer_compute_dtype="bfloat16"),
                             device="cpu")
    port.load_state_dict(from_jax_params(params), strict=True)
    return jax_cfg, params, port


def _inputs():
    rng = np.random.default_rng(22)
    b, t = 2, 16
    lens = np.asarray([16, 11])
    ints = [rng.integers(1, hi, (b, t)) for hi in (20, 12, 3)]
    bert = [(0.2 * rng.normal(size=(b, t, 1024))).astype(np.float32) for _ in range(3)]
    return (ints[0], lens, np.asarray([1, 3]), ints[1], ints[2], *bert)


INFER_BF16 = os.path.join(os.path.dirname(__file__), "goldens", "infer_bf16.npz")
INFER_MAX_FRAMES = 96
INFER_KNOBS = dict(noise_scale=0.0, noise_scale_w=0.0, sdp_ratio=0.4)


def infer_fingerprint(params, args) -> np.ndarray:
    """Of the parameters, the inputs, the model config and the call's knobs."""
    return golden_values.fingerprint(params, args, TINY, INFER_MAX_FRAMES, INFER_KNOBS)


def test_infer_bf16_matches_jax_bf16(models):
    """Synthesizer.infer with infer_compute_dtype "bfloat16" against the JAX
    Synthesizer's at zero noise: y_lengths, y_mask and the alignment equal
    (enc_p and the duration predictors run in fp32 in both), the wave
    finite and no further from JAX's bf16 wave than JAX's bf16 wave lies
    from its fp32 one (max-abs over the valid samples; both printed), and
    no further from JAX's fp32 wave than JAX's bf16 wave is. The JAX
    syntheses (fp32 and bf16, dense attention) come from
    tests/goldens/infer_bf16.npz, written by tests/goldens/make_infer_bf16.py
    from these parameters and inputs (their fingerprint must match)."""
    jax_cfg, params, port = models
    max_frames, knobs = INFER_MAX_FRAMES, INFER_KNOBS
    args = _inputs()
    got = golden_values.load(INFER_BF16, infer_fingerprint(params, args),
                             "tests/goldens/make_infer_bf16.py")
    want = {dt: [got[f"{dt}/{i}"] for i in range(4)] for dt in ("float32", "bfloat16")}
    with torch.inference_mode():
        wave, attn, y_mask, y_len = port.infer(*(torch.tensor(a) for a in args),
                                               max_frames, **knobs)
    assert wave.dtype == torch.float32 and torch.isfinite(wave).all()
    for dt in want:
        assert np.array_equal(y_len.numpy(), want[dt][3])
        assert np.array_equal(attn.numpy(), want[dt][1])
        assert np.array_equal(y_mask.numpy(), want[dt][2])
    valid = np.repeat(want["float32"][2], jax_cfg.hop_length, axis=1).astype(bool)
    port_err = np.abs(wave.numpy() - want["bfloat16"][0])[valid].max()
    jax_err = np.abs(want["bfloat16"][0] - want["float32"][0])[valid].max()
    port_fp32_err = np.abs(wave.numpy() - want["float32"][0])[valid].max()
    print(f"bf16 waves: port vs JAX bf16 {port_err:.3e}; JAX bf16 vs JAX fp32 "
          f"{jax_err:.3e}; port bf16 vs JAX fp32 {port_fp32_err:.3e}")
    assert 0.0 < jax_err and port_err <= jax_err and port_fp32_err <= jax_err


def _write_config(path, flow: bool):
    model = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()
             if k not in ("n_vocab", "spec_channels", "n_speakers", "segment_size")}
    model["resblock_dilation_sizes"] = [list(d) for d in TINY["resblock_dilation_sizes"]]
    model["use_transformer_flow"] = flow
    hps = dict(version="2.3", train=dict(segment_size=8 * 16),
               data=dict(sampling_rate=44100, filter_length=64, hop_length=16,
                         n_speakers=4), model=model)
    path.write_text(json.dumps(hps))
    return str(path)


@pytest.mark.parametrize("flow", [True, False], ids=["transformer-flow", "vits1-flow"])
def test_loader_bf16_engine(tmp_path, flow):
    """load_tts_engine(compute_dtype="bfloat16") from a written config.json
    and G_0.pth: the same state_dict as the float32 engine (fp32 under the
    reference's names), the flow and decoder copies in bf16 with fp32
    LayerNorms, and run_prepared waves that are finite, in [-1, 1] and of
    the float32 engine's lengths; an unknown dtype raises."""
    config = _write_config(tmp_path / "config.json", flow)
    kw = dict(device="cpu", text_buckets=(16,), frames_per_token=4)
    # the loader's own random init, the flow's zero-init post convs filled
    sd = load_tts_engine(config, None, seed=4, **kw).model.state_dict()
    gen = torch.Generator().manual_seed(3)
    for key in sd:
        if ".post." in key:
            sd[key] = 0.05 * torch.randn(sd[key].shape, generator=gen)
    pth = tmp_path / "G_0.pth"
    torch.save({"model": sd, "iteration": 0}, pth)
    rng = np.random.default_rng(23)
    reqs = []
    for n in (9, 14):
        feats = [(0.3 * rng.normal(size=(n, 1024))).astype(np.float32) for _ in range(3)]
        reqs.append(PreparedRequest(
            inputs=(rng.integers(1, 20, n), rng.integers(0, 12, n), rng.integers(0, 3, n),
                    *feats), sid=n % 4, seed=5))
    engines = {dt: load_tts_engine(config, str(pth), compute_dtype=dt, **kw)
               for dt in ("float32", "bfloat16")}
    f32, b16 = engines["float32"], engines["bfloat16"]
    assert b16.model.cfg == dataclasses.replace(f32.model.cfg,
                                                infer_compute_dtype="bfloat16")
    sd_f, sd_b = f32.model.state_dict(), b16.model.state_dict()
    assert sd_f.keys() == sd_b.keys()
    assert all(sd_b[k].dtype == torch.float32 and torch.equal(sd_f[k], sd_b[k])
               for k in sd_f)
    kinds = {type(m).__name__: p.dtype for st in b16.stages for m in st.modules()
             for p in m.parameters(recurse=False)}
    assert kinds.pop("LayerNorm", torch.float32) == torch.float32
    assert set(kinds.values()) == {BF16}
    assert not any(hasattr(m, "weight_g") for st in b16.stages for m in st.modules())
    want = f32.run_prepared(reqs)
    got = b16.run_prepared(reqs)
    assert [len(w) for w in got] == [len(w) for w in want]
    for w in got:
        assert w.dtype == np.float32 and np.isfinite(w).all() and np.abs(w).max() <= 1.0
    with pytest.raises(ValueError, match="float16"):
        load_tts_engine(config, str(pth), compute_dtype="float16", **kw)
