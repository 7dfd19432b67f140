"""Offline data preparation (reference: resample.py, preprocess_text.py,
bert_gen.py, spec_gen.py, emo_gen.py, webui_preprocess.py).

Counterpart of `bert_vits2_tpu/preprocess/`, with its functions, CLIs,
arguments, file names, cache names and array layouts, so that a corpus
prepared by either package trains in either. Host-side numpy and scipy,
except the entry points that run a model (`bert_gen` without `--random`,
`emo_gen`), which take `--device` and default to the card:

    python -m bert_vits2_tpu_torch.preprocess.wizard -d <name> --steps all
    python -m bert_vits2_tpu_torch.preprocess.resample --in-dir raw --out-dir wavs
    python -m bert_vits2_tpu_torch.preprocess.text --transcription-path x.list ...
    python -m bert_vits2_tpu_torch.preprocess.bert_gen -c config.json [--random]
    python -m bert_vits2_tpu_torch.preprocess.spec_gen -c config.json
    python -m bert_vits2_tpu_torch.preprocess.emo_gen -c config.json --mode clap
"""

from bert_vits2_tpu_torch.preprocess.resample import resample_file
from bert_vits2_tpu_torch.preprocess.text import preprocess_text

__all__ = ["resample_file", "preprocess_text"]
