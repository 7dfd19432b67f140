"""Host-side utilities: the training loop's logging, TensorBoard summaries,
step timing, the git stamp and the images of `Trainer.evaluate`
(reference: utils.py:144-378), the release reader (`model_tools.py`) and
the WAV encoding of the HTTP server's responses (`audio.py`)."""
