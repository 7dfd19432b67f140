"""Write tests/goldens/bf16_train.npz: the JAX package's values that
tests/test_torch_bf16_train.py holds the port's bf16 training to, on that
file's inputs and random parameter trees (`reference_inputs`):

- the bf16 stages (`_jax_stages` below): the posterior encoder's m_q and logs_q,
  the flow forward, the decoder on bf16 g, the multi-period
  discriminator's logits, and the gradients of the test's scalars against
  the float32 parameters, by the port's parameter names;
- the JAX bf16 step (`_jax_bf16_step` below, composed as
  tests/test_torch_train_step.py composes the fp32 one, the decoder on
  bf16 g): its metrics and the updated parameters of G and D, by the
  port's names.

Run from the repository root on the CPU (~3 min: two JAX compiles):

    JAX_PLATFORMS=cpu python tests/goldens/make_bf16_train.py

The test checks the fingerprint stored beside the values against its own
inputs, so a change to the inputs or the trees asks for this script again.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

import golden_values  # noqa: E402
import test_torch_bf16_train as t  # noqa: E402
from bert_vits2_tpu.models.generator import Generator as JaxGenerator  # noqa: E402
from bert_vits2_tpu.ops.masking import slice_segments as jax_slice_segments  # noqa: E402
from bert_vits2_tpu.ops.stft import mel_spectrogram as jax_mel_spectrogram  # noqa: E402
from bert_vits2_tpu.ops.stft import spec_to_mel as jax_spec_to_mel  # noqa: E402
from bert_vits2_tpu.train import losses as jax_losses  # noqa: E402
from bert_vits2_tpu.train import step as jax_step  # noqa: E402
from bert_vits2_tpu_torch.compat.params import from_jax_mpd_params, from_jax_params  # noqa: E402

JBF16 = jnp.bfloat16
from test_torch_train_step import BATCH_KEYS  # noqa: E402

LR, DATA, TINY = t.LR, t.DATA, t.TINY


def _jax_stages(jax_model, jmpd, x):
    """The stages in bf16 on the JAX side -> fn(params, mpd params) ->
    (outputs, generator gradients, mpd outputs, mpd gradients) of their
    scalars. The posterior's sample z is left out: its noise is the only
    thing it adds to m_q and logs_q."""
    c = lambda a: jnp.asarray(a, JBF16)  # noqa: E731
    m = x["m"]

    def stages(mod, y, lens, g, z, zd):
        _, mq, lq, _ = mod.enc_q(y, lens, g=g)
        return mq, lq, mod.flow(z, c(m), g=g), mod.dec(zd, g=g)

    def synth_loss(p):
        outs = jax_model.apply(
            {"params": p}, c(x["y"]), x["lens"], c(x["g"]), c(x["z"]), c(x["zd"]),
            method=stages, rngs={"noise": jax.random.key(0)})
        s = sum(jnp.sum(o.astype(jnp.float32) * r * (m[..., None] if o.ndim == 3 else 1))
                for o, r in zip(outs, x["r"]))
        return s, outs

    def mpd_loss(p):
        rs, gs, fr, fg = jmpd.apply({"params": p}, c(x["wy"]), c(x["wh"]))
        s = sum(jnp.sum(a.astype(jnp.float32)) for a in rs + gs)
        s += sum(jnp.mean(jnp.abs(a.astype(jnp.float32))) for d in fr + fg for a in d)
        return s, rs + gs

    def run(p_g, p_d):
        (_, outs), grads = jax.value_and_grad(synth_loss, has_aux=True)(p_g)
        (_, mouts), mgrads = jax.value_and_grad(mpd_loss, has_aux=True)(p_d)
        return outs, grads, mouts, mgrads

    return run


def _jax_bf16_step(jax_model, jmpd, data_cfg, seg):
    """The JAX bf16 step's mathematics with deterministic=True
    (bert_vits2_tpu/train/step.py:294-421 under bf16_run, composed as
    tests/test_torch_train_step.py composes the fp32 step, without the
    duration discriminator, which bf16_run leaves in fp32): D update on
    bf16 waves, then the generator loss against the updated D; each
    optimizer clips by its global norm first. The caller makes the decoder
    take g in bf16 (R.6). -> fn(params, D params, batch) -> (metrics,
    (updated params, updated D params))."""
    hop = data_cfg.hop_length
    mel_args = (data_cfg.filter_length, data_cfg.n_mel_channels,
                data_cfg.sampling_rate)
    tcfg = jax_step.TrainConfig(bf16_run=True)
    tx_g = jax_step.make_optimizer(tcfg, tcfg.grad_clip_g)
    tx_d = jax_step.make_optimizer(tcfg, tcfg.grad_clip_d)
    sg = jax.lax.stop_gradient
    dc = lambda a: a.astype(JBF16)  # noqa: E731

    def update(tx, params, grads):
        opt = jax_step._set_lr(tx.init(params), LR)
        upd, _ = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd)

    def run(p_g, p_d, batch):
        def forward(p):
            o = jax_model.apply(
                {"params": p}, *(batch[k] for k in BATCH_KEYS), mas_noise_scale=0.01,
                deterministic=True, rngs={"noise": jax.random.key(0)})
            o["wave_slice"] = o["wave_slice"].astype(jnp.float32)
            return o, o.pop("ids_slice")

        out, vjp_fn, ids = jax.vjp(forward, p_g, has_aux=True)
        mel = jax_spec_to_mel(batch["spec"], *mel_args, data_cfg.mel_fmin,
                              data_cfg.mel_fmax)
        y_mel = jax_slice_segments(mel, ids, seg)
        y_slice = jax_slice_segments(batch["wave"][..., None], ids * hop,
                                     seg * hop)[..., 0]

        def d_loss_fn(p):
            y_d_r, y_d_g, _, _ = jmpd.apply({"params": p}, dc(y_slice),
                                            dc(sg(out["wave_slice"])))
            return jax_losses.discriminator_loss(y_d_r, y_d_g)[0]

        loss_d, grads_d = jax.value_and_grad(d_loss_fn)(p_d)
        p_d2 = update(tx_d, p_d, grads_d)

        def g_loss_fn(o):
            yh = o["wave_slice"]
            yh_mel = jax_mel_spectrogram(yh, *mel_args, hop, data_cfg.win_length,
                                         data_cfg.mel_fmin, data_cfg.mel_fmax)
            _, y_d_g, fmap_r, fmap_g = jmpd.apply({"params": p_d2}, dc(y_slice), dc(yh))
            aux = {
                "loss/g/gen": jax_losses.generator_loss(y_d_g)[0],
                "loss/g/fm": jax_losses.feature_loss(fmap_r, fmap_g),
                "loss/g/mel": jnp.mean(jnp.abs(y_mel - yh_mel)) * 45.0,
                "loss/g/dur": jnp.sum(o["l_length"].astype(jnp.float32)),
                "loss/g/kl": jax_losses.kl_loss(o["z_p"], o["logs_q"], o["m_p"],
                                                o["logs_p"], o["y_mask"]),
            }
            return sum(aux.values()), aux

        (loss_g, aux), d_out = jax.value_and_grad(g_loss_fn, has_aux=True)(out)
        (grads_g,) = vjp_fn(d_out)
        metrics = dict(aux)
        metrics.update({"loss/d/total": loss_d, "loss/g/total": loss_g,
                        "grad_norm_g": optax.global_norm(grads_g),
                        "grad_norm_d": optax.global_norm(grads_d)})
        return metrics, (update(tx_g, p_g, grads_g), p_d2)

    return run


def _run_fast(fn, *args):
    """fn(*args), jitted with LLVM's expensive passes off."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_llvm_disable_expensive_passes": True,
        "xla_backend_optimization_level": 0})(*args)



def main():
    jax_model, p_g, jmpd, p_d, x, batch = t.reference_inputs()
    arrays = {}
    with pytest.MonkeyPatch.context() as mp:
        t.patch_noise(mp, seed=3)
        outs, grads, mouts, mgrads = jax.device_get(_run_fast(
            _jax_stages(jax_model, jmpd, x), p_g, p_d))
    with pytest.MonkeyPatch.context() as mp:
        t.patch_noise(mp, seed=t.NOISE_SEED)
        # R.6: the JAX decoder takes g in the activations' dtype, as the
        # port's does
        dec_call = JaxGenerator.__call__
        mp.setattr(JaxGenerator, "__call__", lambda self, z, g=None, **kw: dec_call(
            self, z, g=None if g is None else g.astype(z.dtype), **kw))
        step = _jax_bf16_step(jax_model, jmpd, jax_step.DataConfig(**DATA),
                                TINY["segment_size"])
        metrics, (new_g, new_d) = jax.device_get(_run_fast(step, p_g, p_d, batch))
    for i, o in enumerate(outs):
        arrays[f"stage_out/{i}"] = np.asarray(o, np.float32)
    for i, o in enumerate(mouts):
        arrays[f"stage_mpd_out/{i}"] = np.asarray(o, np.float32)
    for n, g in from_jax_params(grads).items():
        if n.startswith(("enc_q.", "flow.", "dec.")):
            arrays[f"stage_grad/{n}"] = g.numpy()
    for n, g in from_jax_mpd_params(mgrads, jmpd.periods).items():
        arrays[f"stage_mpd_grad/{n}"] = g.numpy()
    for k, v in metrics.items():
        arrays[f"step_metric/{k}"] = np.asarray(v, np.float64)
    for n, v in from_jax_params(new_g).items():
        arrays[f"step_g/{n}"] = v.numpy()
    for n, v in from_jax_mpd_params(new_d, jmpd.periods).items():
        arrays[f"step_d/{n}"] = v.numpy()
    golden_values.save(t.GOLDENS, t.fingerprint(p_g, p_d, x, batch), arrays)


if __name__ == "__main__":
    main()
