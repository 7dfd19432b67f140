"""Write tests/goldens/stages.npz: the JAX package's stage values that
tests/test_torch_stages.py holds the port's `compat/stages.py` to, on that
file's parameter tree (`params_and_inputs`) and inputs: each jitted stage
of `make_stages` (the SDP with given noise through `z_in`), and
`run_stages` at zero noise with both duration predictors mixed.

Run from the repository root on the CPU (~1 min: a JAX compile per stage):

    JAX_PLATFORMS=cpu python tests/goldens/make_stages.py

The test checks the fingerprint stored beside the values against its own
inputs, so a change to the inputs or the tree asks for this script again.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py

import golden_values  # noqa: E402
import test_torch_stages as t  # noqa: E402
from bert_vits2_tpu.compat.stages import make_stages, run_stages  # noqa: E402
from bert_vits2_tpu.models import ModelConfig as JaxModelConfig  # noqa: E402
from bert_vits2_tpu.models import Synthesizer as JaxSynthesizer  # noqa: E402
from bert_vits2_tpu.ops.masking import sequence_mask  # noqa: E402


def main():
    params, inp = t.params_and_inputs()
    model = JaxSynthesizer(JaxModelConfig(**t.CFG))
    stages = make_stages(model, params)
    a = {k: jnp.asarray(v) for k, v in inp.items()}
    g = stages["emb"](a["sid"])
    x_h, m_p, logs_p, x_mask = stages["enc_p"](
        a["x"], a["x_lengths"], a["tone"], a["language"], a["bert"], a["ja_bert"],
        a["en_bert"], g)
    sdp = jax.jit(lambda p, *args: model.apply(
        {"params": p}, method=lambda m: m.sdp(
            args[0], args[1], g=args[2], reverse=True, z_in=args[3],
            deterministic=True)))
    y_mask = sequence_mask(a["y_lengths"], t.MAX_FRAMES).astype(jnp.float32)
    wave, y_len = run_stages(
        stages, a["x"], a["x_lengths"], a["sid"], a["tone"], a["language"], a["bert"],
        a["ja_bert"], a["en_bert"], t.MAX_FRAMES, **t.RUN_KNOBS)
    arrays = {
        "g": g, "x_h": x_h, "m_p": m_p, "logs_p": logs_p, "x_mask": x_mask,
        "logw_sdp": sdp(params, x_h, x_mask, g, a["z_sdp"]),
        "logw_dp": stages["dp"](x_h, x_mask, g),
        "z": stages["flow"](a["z_p"], y_mask, g),
        "wave": stages["dec"](a["z_dec"], g, y_mask),
        "run_wave": wave, "run_y_lengths": y_len,
    }
    golden_values.save(os.path.join(HERE, "stages.npz"), t.fingerprint(params, inp),
                       {k: np.asarray(v) for k, v in arrays.items()})


if __name__ == "__main__":
    main()
