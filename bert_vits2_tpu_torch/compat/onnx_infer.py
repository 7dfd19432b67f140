"""Run exported ONNX stage graphs end-to-end (reference analog:
onnx_modules/V230_OnnxInference/__init__.py — the MoeVS-style numpy glue
around the 6 graphs).

A copy of `bert_vits2_tpu/compat/onnx_infer.py`. Uses onnxruntime when
importable (real deployments); falls back to the in-repo numpy evaluator
(compat/onnx_eval.py) so exported artifacts can be run where onnxruntime
is not installed.

The exported graphs are static-shape (a (t_x, max_frames) bucket, matching
the framework's bucketed serving); this runner pads inputs to the bucket
and trims the waveform to the predicted length.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _np_sequence_mask(lengths, max_len):
    return (np.arange(max_len)[None, :] < lengths[:, None]).astype(np.float32)


def _np_generate_path(w_ceil, x_mask, y_mask):
    """duration [b, t_x], masks [b, t_x]/[b, t_y] -> attn [b, t_y, t_x]."""
    b, t_x = w_ceil.shape
    t_y = y_mask.shape[1]
    cum = np.cumsum(w_ceil * x_mask, axis=-1)  # [b, t_x]
    path = (
        np.arange(t_y)[None, None, :] < cum[:, :, None]
    )  # [b, t_x, t_y]
    path = path ^ np.pad(path, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    attn = path.transpose(0, 2, 1).astype(np.float32)
    return attn * x_mask[:, None, :] * y_mask[:, :, None]


class _EvalSession:
    """onnxruntime-compatible shim over compat.onnx_eval.OnnxEvaluator."""

    def __init__(self, path):
        from bert_vits2_tpu_torch.compat.onnx_eval import OnnxEvaluator

        with open(path, "rb") as f:
            self._ev = OnnxEvaluator(f.read())

    def run(self, _outs, feeds: dict):
        return self._ev(**feeds)


def _session(path):
    try:  # pragma: no cover - onnxruntime is not installed where the port runs
        import onnxruntime as ort

        return ort.InferenceSession(
            path, providers=["CPUExecutionProvider"]
        )
    except ImportError:
        return _EvalSession(path)


class OnnxTTSPipeline:
    """Glue the 6 exported graphs like the reference ONNX runner.

    model_dir must contain `{name}_{stage}.onnx` + `config.json` as written
    by compat.onnx_export.export_onnx.
    """

    def __init__(self, model_dir: str, name: str | None = None):
        cfg_path = os.path.join(model_dir, "config.json")
        with open(cfg_path, encoding="utf-8") as f:
            self.config = json.load(f)
        name = name or self.config["Name"]
        shapes = self.config.get("Shapes", {})
        self.t_x = int(shapes.get("t_x", 128))
        self.max_frames = int(shapes.get("max_frames", 1024))
        self.hop = int(self.config.get("Hop", 512))
        self.sessions = {
            stage: _session(os.path.join(model_dir, f"{name}_{stage}.onnx"))
            for stage in ("emb", "enc_p", "sdp", "dp", "flow", "dec")
        }

    def __call__(
        self,
        seq,
        tone,
        language,
        bert_zh,
        bert_jp,
        bert_en,
        sid,
        seed: int = 114514,
        seq_noise_scale: float = 0.667,
        sdp_noise_scale: float = 0.8,
        length_scale: float = 1.0,
        sdp_ratio: float = 0.0,
        zin=None,
        z_eps=None,
    ):
        """-> (wave [b, samples], y_length [b]). Arrays are numpy.

        zin / z_eps: optional pre-drawn noise (for parity tests); defaults
        are seeded np.random like the reference runner
        (V230_OnnxInference/__init__.py:87-118).
        """
        seq = np.atleast_2d(np.asarray(seq))
        tone = np.atleast_2d(np.asarray(tone))
        language = np.atleast_2d(np.asarray(language))
        b, n = seq.shape
        if n > self.t_x:
            raise ValueError(f"sequence length {n} > export bucket {self.t_x}")

        def pad_ids(a):
            return np.pad(a, ((0, 0), (0, self.t_x - n))).astype(np.int64)

        def pad_bert(a):
            a = np.asarray(a, np.float32)
            if a.ndim == 3:
                a = a[0]
            if a.shape[0] == 1024:  # [1024, t] -> [t, 1024]
                a = a.T
            return np.pad(a, ((0, self.t_x - n), (0, 0)))

        rng = np.random.RandomState(seed)
        g = self.sessions["emb"].run(None, {"sid": np.asarray(sid, np.int64)})[0]
        g = g[..., None].astype(np.float32)  # [b, gin, 1]

        x, m_p, logs_p, x_mask = self.sessions["enc_p"].run(
            None,
            {
                "x": pad_ids(seq),
                "x_lengths": np.full((b,), n, np.int64),
                "t": pad_ids(tone),
                "language": pad_ids(language),
                "bert_0": pad_bert(bert_zh),
                "bert_1": pad_bert(bert_jp),
                "bert_2": pad_bert(bert_en),
                "g": g,
            },
        )
        if zin is None:
            zin = rng.randn(b, 2, self.t_x).astype(np.float32) * sdp_noise_scale
        logw_sdp = self.sessions["sdp"].run(
            None,
            {"x": x, "x_mask": x_mask, "zin": np.asarray(zin, np.float32),
             "g": g},
        )[0]
        logw_dp = self.sessions["dp"].run(
            None, {"x": x, "x_mask": x_mask, "g": g}
        )[0]
        logw = logw_sdp * sdp_ratio + logw_dp * (1.0 - sdp_ratio)

        xm = x_mask[:, 0, :]  # [b, t_x]
        w_ceil = np.ceil(np.exp(logw[:, 0, :]) * xm * length_scale)
        y_lengths = np.clip(
            w_ceil.sum(-1), 1.0, self.max_frames
        ).astype(np.int64)
        y_mask = _np_sequence_mask(y_lengths, self.max_frames)
        attn = _np_generate_path(w_ceil, xm, y_mask)  # [b, t_y, t_x]

        # prior expand (channel-first m_p/logs_p: [b, d, t_x])
        m_p_y = np.einsum("byx,bdx->bdy", attn, m_p)
        logs_p_y = np.einsum("byx,bdx->bdy", attn, logs_p)
        if z_eps is None:
            z_eps = rng.randn(*m_p_y.shape).astype(np.float32)
        z_p = m_p_y + z_eps * np.exp(logs_p_y) * seq_noise_scale

        z = self.sessions["flow"].run(
            None,
            {"z_p": z_p.astype(np.float32),
             "y_mask": y_mask[:, None, :].astype(np.float32), "g": g},
        )[0]
        o = self.sessions["dec"].run(
            None,
            {"z_in": (z * y_mask[:, None, :]).astype(np.float32), "g": g},
        )[0]
        wave = o[:, 0, :]
        return wave, y_lengths
