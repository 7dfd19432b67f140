"""File/console logger + TensorBoard summary writer (reference:
utils.py:144-160 summarize, utils.py:366-378 get_logger). A copy of
`bert_vits2_tpu/utils/logging.py` under the port's logger name."""

from __future__ import annotations

import logging
import os

import numpy as np


def get_logger(model_dir: str | None = None, filename: str = "train.log") -> logging.Logger:
    logger = logging.getLogger("bert_vits2_tpu_torch")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if model_dir is not None:
        os.makedirs(model_dir, exist_ok=True)
        path = os.path.join(model_dir, filename)
        if not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(path)
            for h in logger.handlers
        ):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def make_writer(log_dir: str):
    """TensorBoard SummaryWriter (torch's); None if tensorboard is not
    installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


def summarize(
    writer,
    global_step: int,
    scalars: dict | None = None,
    images: dict | None = None,
    audios: dict | None = None,
    audio_sampling_rate: int = 44100,
) -> None:
    """Mirror of utils.summarize (utils.py:144-160); no-op without a writer."""
    if writer is None:
        return
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(np.asarray(v)), global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, np.asarray(v), global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        writer.add_audio(
            k,
            np.asarray(v, np.float32).reshape(1, -1),
            global_step,
            audio_sampling_rate,
        )
