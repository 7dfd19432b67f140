"""Write tests/goldens/infer_bf16.npz: the JAX package's syntheses that
tests/test_torch_bf16.py::test_infer_bf16_matches_jax_bf16 holds the
port's bf16 `Synthesizer.infer` to, on that file's parameters (the
`models` fixture's tree) and inputs (`_inputs`): `infer` at zero noise
with infer_compute_dtype "float32" and "bfloat16", dense attention
(`force_lax_attention`), jitted.

Run from the repository root on the CPU (~1 min: two JAX compiles):

    JAX_PLATFORMS=cpu python tests/goldens/make_infer_bf16.py

The test checks the fingerprint stored beside the values against its own
inputs, so a change to the inputs or the tree asks for this script again.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

import golden_values  # noqa: E402
import test_torch_bf16 as t  # noqa: E402
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig  # noqa: E402
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from bert_vits2_tpu.ops.attention_pallas import force_lax_attention  # noqa: E402


def main():
    jax_cfg = JaxModelConfig(**t.TINY)
    params = t.random_synth_params(JaxSynthesizer(jax_cfg), seed=21)  # as `models`
    args = t._inputs()

    def infer(p, dtype, *a):
        model = JaxSynthesizer(dataclasses.replace(jax_cfg, infer_compute_dtype=dtype))
        return model.apply({"params": p}, *a, t.INFER_MAX_FRAMES,
                           method=JaxSynthesizer.infer, rngs={"noise": jax.random.key(0)},
                           **t.INFER_KNOBS)

    run = jax.jit(infer, static_argnums=1)
    arrays = {}
    with force_lax_attention():
        for dt in ("float32", "bfloat16"):
            for i, o in enumerate(run(params, dt, *args)):
                arrays[f"{dt}/{i}"] = np.asarray(o)
    golden_values.save(t.INFER_BF16, t.infer_fingerprint(params, args), arrays)


if __name__ == "__main__":
    main()
