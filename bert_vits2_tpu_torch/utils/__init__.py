"""Host-side utilities: the training loop's logging, TensorBoard summaries,
step timing, the git stamp and the images of `Trainer.evaluate`
(reference: utils.py:144-378), and the release reader (`model_tools.py`)."""
