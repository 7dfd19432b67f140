"""Batched synthesis engine, from text or from prepared requests, and its
loader."""

from bert_vits2_tpu_torch.infer.api import PreparedRequest, TTSEngine, get_text
from bert_vits2_tpu_torch.infer.loader import load_generator_params, load_tts_engine

__all__ = ["PreparedRequest", "TTSEngine", "get_text", "load_generator_params",
           "load_tts_engine"]
