"""Write tests/goldens/train_step.npz: the JAX package's values that
tests/test_torch_train_step.py holds the port's training forward and GAN
step to, on that file's inputs and random parameter trees
(`reference_inputs`): the JAX step's mathematics with deterministic=True
(`_jax_step` below), namely the training forward's outputs, the step's
losses and norms by name, and the gradients of G, D and the duration D as
JAX trees.

Run from the repository root on the CPU (~2 min: one JAX compile):

    JAX_PLATFORMS=cpu python tests/goldens/make_train_step.py

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
import optax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

import golden_values  # noqa: E402
import test_torch_train_step as t  # noqa: E402
from bert_vits2_tpu.ops.masking import slice_segments as jax_slice_segments  # noqa: E402
from bert_vits2_tpu.ops.stft import mel_spectrogram as jax_mel_spectrogram  # noqa: E402
from bert_vits2_tpu.ops.stft import spec_to_mel as jax_spec_to_mel  # noqa: E402
from bert_vits2_tpu.train import losses as jax_losses  # noqa: E402
from bert_vits2_tpu.train import step as jax_step  # noqa: E402

BATCH_KEYS, LR, TINY = t.BATCH_KEYS, t.LR, t.TINY


def _jax_forward(jax_model, params, batch):
    return jax_model.apply(
        {"params": params}, *(batch[k] for k in BATCH_KEYS),
        mas_noise_scale=0.01, deterministic=True,
        rngs={"noise": jax.random.key(0)})


def _jax_step(jax_model, jmpd, jdd, data_cfg, seg):
    """The JAX step's mathematics with deterministic=True: D update, duration
    D update, then the generator loss against the updated discriminators
    (bert_vits2_tpu/train/step.py:294-421, the order of its `d_loss_fn`,
    `dd_loss_fn` and `g_loss_fn`). The generator forward is traced once
    (`jax.vjp`) and serves all three losses, as the step's two forwards
    with equal rngs do."""
    hop = data_cfg.hop_length
    mel_args = (data_cfg.filter_length, data_cfg.n_mel_channels,
                data_cfg.sampling_rate)
    tx_d = jax_step.make_optimizer(jax_step.TrainConfig(), None)
    sg = jax.lax.stop_gradient

    def update(params, grads):
        opt = jax_step._set_lr(tx_d.init(params), LR)
        upd, _ = tx_d.update(grads, opt, params)
        return optax.apply_updates(params, upd)

    def dd_pairs(p_dd, o, sg):
        args = [sg(o[k]) for k in ("x_hidden", "x_mask", "logw_")]
        r1, g1 = jdd.apply({"params": p_dd}, *args, sg(o["logw"]), g=sg(o["g"]))
        r2, g2 = jdd.apply({"params": p_dd}, *args, sg(o["logw_sdp"]), g=sg(o["g"]))
        return [r1, r2], [g1, g2]

    def run(p_g, p_d, p_dd, batch):
        def forward(p):
            o = _jax_forward(jax_model, p, batch)
            return o, o.pop("ids_slice")

        out, vjp_fn, ids = jax.vjp(forward, p_g, has_aux=True)
        mel = jax_spec_to_mel(batch["spec"], *mel_args, data_cfg.mel_fmin,
                              data_cfg.mel_fmax)
        y_mel = jax_slice_segments(mel, ids, seg)
        y_slice = jax_slice_segments(batch["wave"][..., None], ids * hop,
                                     seg * hop)[..., 0]

        def d_loss_fn(p):
            y_d_r, y_d_g, _, _ = jmpd.apply({"params": p}, y_slice,
                                            sg(out["wave_slice"]))
            return jax_losses.discriminator_loss(y_d_r, y_d_g)[0]

        def dd_loss_fn(p):
            return jax_losses.discriminator_loss(*dd_pairs(p, out, sg))[0]

        loss_d, grads_d = jax.value_and_grad(d_loss_fn)(p_d)
        loss_dd, grads_dd = jax.value_and_grad(dd_loss_fn)(p_dd)
        p_d2, p_dd2 = update(p_d, grads_d), update(p_dd, grads_dd)

        def g_loss_fn(o):
            yh = o["wave_slice"]
            yh_mel = jax_mel_spectrogram(yh, *mel_args, hop, data_cfg.win_length,
                                         data_cfg.mel_fmin, data_cfg.mel_fmax)
            _, y_d_g, fmap_r, fmap_g = jmpd.apply({"params": p_d2}, y_slice, yh)
            aux = {
                "loss/g/gen": jax_losses.generator_loss(y_d_g)[0],
                "loss/g/fm": jax_losses.feature_loss(fmap_r, fmap_g),
                "loss/g/mel": jnp.mean(jnp.abs(y_mel - yh_mel)) * 45.0,
                "loss/g/dur": jnp.sum(o["l_length"]),
                "loss/g/kl": jax_losses.kl_loss(o["z_p"], o["logs_q"], o["m_p"],
                                                o["logs_p"], o["y_mask"]),
                "loss/g/dur_gen": jax_losses.generator_loss(
                    dd_pairs(p_dd2, o, lambda a: a)[1])[0],
            }
            return sum(aux.values()), aux

        (loss_g, aux), d_out = jax.value_and_grad(g_loss_fn, has_aux=True)(out)
        (grads_g,) = vjp_fn(d_out)
        metrics = dict(aux)
        metrics.update({"loss/d/total": loss_d, "loss/dur_disc/total": loss_dd,
                        "loss/g/total": loss_g,
                        "grad_norm_g": optax.global_norm(grads_g),
                        "grad_norm_d": optax.global_norm(grads_d),
                        "grad_norm_dur": optax.global_norm(grads_dd)})
        return dict(out, ids_slice=ids), metrics, grads_g, grads_d, grads_dd

    return run


def main():
    (jax_model, p_g, _), (jmpd, p_d, _), (jdd, p_dd, _), batch = t.reference_inputs()
    fp = t.fingerprint(p_g, p_d, p_dd, batch)
    with pytest.MonkeyPatch.context() as mp:
        t.patch_noise(mp, seed=t.NOISE_SEED)
        run = jax.jit(_jax_step(jax_model, jmpd, jdd, jax_step.DataConfig(**t.DATA),
                                TINY["segment_size"]))
        # the compile dominates: skip LLVM's expensive passes
        run = run.lower(p_g, p_d, p_dd, batch).compile(compiler_options={
            "xla_llvm_disable_expensive_passes": True,
            "xla_backend_optimization_level": 0})
        result = jax.device_get(run(p_g, p_d, p_dd, batch))
    out, metrics, grads = result[0], result[1], result[2:]
    arrays = {**golden_values.flatten(out, "out"),
              **golden_values.flatten(metrics, "metric")}
    for name, tree in zip(t.GRADS, grads):
        arrays.update(golden_values.flatten(tree, name))
    golden_values.save(t.GOLDENS, fp, arrays)


if __name__ == "__main__":
    main()
