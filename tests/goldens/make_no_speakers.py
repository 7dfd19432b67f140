"""Write tests/goldens/no_speakers.npz: the JAX package's values that
tests/test_torch_slm.py holds the port's n_speakers == 0 Synthesizer to,
on that file's inputs (`no_speakers_inputs`): the training forward with
deterministic=True on the noise tape of seed 6, and `infer` at zero noise
for 40 frames with the batch's spectrogram as the reference, in one jitted
function.

Run from the repository root on the CPU (~1 min: one JAX compile):

    JAX_PLATFORMS=cpu python tests/goldens/make_no_speakers.py

The test checks the fingerprint stored beside the values against its own
inputs, so a change to the inputs or the tree asks for this script again.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

import golden_values  # noqa: E402
import test_torch_slm as t  # noqa: E402
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402


def main():
    jax_model, params, batch = t.no_speakers_inputs()

    def both(p, b):
        fwd = jax_model.apply(
            {"params": p}, *(b[k] for k in t.BATCH_KEYS),
            mas_noise_scale=t.NO_SPEAKERS_MAS_NOISE,
            deterministic=True, rngs={"noise": jax.random.key(0)})
        inf = jax_model.apply(
            {"params": p}, *(b[k] for k in t.NO_SPEAKERS_INFER), t.NO_SPEAKERS_FRAMES,
            noise_scale=0.0,
            noise_scale_w=0.0, y=b["spec"], method=JaxSynthesizer.infer,
            rngs={"noise": jax.random.key(0)})
        return fwd, inf

    with pytest.MonkeyPatch.context() as mp:
        t.patch_noise(mp, seed=t.NO_SPEAKERS_SEED)
        # the compile dominates: skip LLVM's expensive passes
        run = jax.jit(both).lower(params, batch).compile(compiler_options={
            "xla_llvm_disable_expensive_passes": True,
            "xla_backend_optimization_level": 0})
        fwd, inf = jax.device_get(run(params, batch))
    arrays = golden_values.flatten(fwd, "fwd")
    arrays.update({f"inf/{i}": a for i, a in enumerate(inf)})
    golden_values.save(t.NO_SPEAKERS, t.no_speakers_fingerprint(params, batch), arrays)


if __name__ == "__main__":
    main()
