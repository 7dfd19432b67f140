"""Host-side utilities of the training loop: logging, TensorBoard summaries,
step timing, the git stamp and the images of `Trainer.evaluate`
(reference: utils.py:144-378)."""
