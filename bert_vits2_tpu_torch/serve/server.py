"""HTTP TTS API server (reference: hiyoriUI.py FastAPI app, 39-735).

Implements the same endpoint surface on the stdlib http.server (no
fastapi/uvicorn in the image): GET/POST /voice, /models/info, /models/add,
/models/delete, /models/get_unloaded, /models/get_local, /status,
/tools/get_audio, /tools/random_example. Threaded: host-side text processing
(g2p + BERT) runs on handler threads; device calls go through a per-model
dynamic micro-batcher (serve/batcher.py) so concurrent requests and a
paragraph's auto-split sentences share one batched synthesis call on the card.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from bert_vits2_tpu_torch.serve.registry import ModelRegistry
from bert_vits2_tpu_torch.serve.textseg import (
    classify_language,
    cut_paragraphs,
    cut_sentences,
    split_by_language,
)
from bert_vits2_tpu_torch.utils.audio import wav_bytes


def _bool(v: str | None, default=False) -> bool:
    if v is None:
        return default
    return str(v).lower() in ("1", "true", "yes", "on")


class TTSService:
    """Framework-independent request logic (so tests can skip HTTP)."""

    def __init__(
        self,
        registry: ModelRegistry,
        models_dir: str = "Data",
        filelists: list | None = None,
        translate_keys: tuple = ("", ""),
        batching: bool = True,
        max_batch: int = 16,
        batch_delay_ms: float = 10.0,
    ):
        self.registry = registry
        self.models_dir = models_dir
        self.lock = threading.Lock()
        self.filelists = filelists or []
        self.translate_keys = translate_keys
        self.batching = batching
        self.max_batch = max_batch
        self.batch_delay_ms = batch_delay_ms
        self._batchers: dict[int, object] = {}  # id(engine) -> MicroBatcher
        self._examples: list | None = None

    def _batcher(self, engine):
        """Lazily attach a MicroBatcher to an engine (one worker per model)."""
        from bert_vits2_tpu_torch.serve.batcher import MicroBatcher

        key = id(engine)
        with self.lock:
            b = self._batchers.get(key)
            if b is None:
                b = MicroBatcher(
                    engine, max_batch=self.max_batch,
                    max_delay_s=self.batch_delay_ms / 1000.0,
                )
                self._batchers[key] = b
        return b

    def close(self):
        """Join every micro-batcher worker thread (server shutdown)."""
        with self.lock:
            batchers, self._batchers = list(self._batchers.values()), {}
        for b in batchers:
            b.close()

    def random_example(self, language: str | None = None):
        """A random (text, speaker, language) row from the loaded filelists
        (hiyoriUI.py /tools/random_example)."""
        import random

        if self._examples is None:
            rows = []
            for fl in self.filelists:
                try:
                    with open(fl, encoding="utf-8") as f:
                        for line in f:
                            parts = line.strip().split("|")
                            if len(parts) >= 4:
                                rows.append(
                                    {"text": parts[3], "speaker": parts[1],
                                     "language": parts[2]}
                                )
                except OSError:
                    continue
            self._examples = rows
        pool = (
            [r for r in self._examples if r["language"] == language]
            if language
            else self._examples
        )
        return random.choice(pool) if pool else None

    # ---- /voice (hiyoriUI.py:197-349 _voice) ----

    def voice(
        self,
        text: str,
        model_id: int,
        speaker,
        language: str = "ZH",
        sdp_ratio: float = 0.2,
        noise: float = 0.667,
        noisew: float = 0.8,
        length: float = 1.0,
        auto_split: bool = False,
        style_text: str | None = None,
        style_weight: float = 0.7,
        emotion=None,
        reference_audio=None,
        silence_ms: int = 200,
    ) -> tuple[np.ndarray, int]:
        """-> (waveform float32, sampling_rate). Raises KeyError/ValueError."""
        if model_id not in self.registry:
            raise KeyError(f"/voice: model {model_id} does not exist")
        engine = self.registry.get(model_id)
        kw = dict(
            sdp_ratio=sdp_ratio,
            noise_scale=noise,
            noise_scale_w=noisew,
            length_scale=length,
        )
        # V2.1/V2.2 emotion conditioning (hiyoriUI.py /voice `emotion` +
        # `reference_audio` params); engines on other versions ignore these
        style_kw = {}
        if getattr(engine.model.cfg, "emotion", "none") != "none":
            style_kw = dict(emotion=emotion, reference_audio=reference_audio)

        def piece_requests(seg_text: str) -> list:
            """One text piece -> ordered PreparedRequests (host-side only)."""
            lang = language.upper()
            lang_map = {"ZH": "ZH", "JA": "JP", "JP": "JP", "EN": "EN"}
            if lang == "MIX":
                # [speaker]<lang>text markup (webui.py mix mode); the
                # `speaker` argument is ignored per-block
                from bert_vits2_tpu_torch.serve.markup import (
                    parse_mix_text,
                    validate_mix_text,
                )

                ok, msg = validate_mix_text(seg_text)
                if not ok:
                    raise ValueError(msg)
                return [
                    engine.prepare(
                        None, spk,
                        segments=[(s, lang_map[l]) for l, s in segs], **kw,
                    )
                    for spk, segs in parse_mix_text(seg_text)
                ]
            if lang == "AUTO":
                segs = split_by_language(
                    seg_text, getattr(engine, "languages", ["zh", "ja", "en"])
                )
                segs = [(s, lang_map[l.upper()]) for s, l in segs]
                if len(segs) == 1:
                    return [
                        engine.prepare(
                            segs[0][0], speaker, language=segs[0][1],
                            style_text=style_text, style_weight=style_weight,
                            **style_kw, **kw,
                        )
                    ]
                return [engine.prepare(None, speaker, segments=segs, **kw)]
            return [
                engine.prepare(
                    seg_text, speaker, language=lang,
                    style_text=style_text, style_weight=style_weight,
                    **style_kw, **kw,
                )
            ]

        # Host-side prep (g2p + BERT) for every piece, then ONE batched
        # synthesis path: a paragraph's sentences and concurrent requests
        # share device calls via the micro-batcher (the reference loops
        # infer() per piece, hiyoriUI.py:320-339).
        if auto_split:
            pieces = [
                s for para in cut_paragraphs(text) for s in cut_sentences(para)
            ]
        else:
            pieces = [text]
        jobs = [piece_requests(p) for p in pieces]
        flat = [r for job in jobs for r in job]
        if not flat:
            return np.zeros(0, np.float32), engine.sampling_rate
        if self.batching:
            flat_waves = self._batcher(engine).submit(flat)
        else:
            # group by the engine's batching key and chunk to max_batch so a
            # long article never becomes one unbounded batch padded to its
            # longest sentence (device OOM + per-length compiles)
            by_key: dict = {}
            for i, r in enumerate(flat):
                by_key.setdefault(engine.group_key(r), []).append(i)
            flat_waves = [None] * len(flat)
            with self.lock:
                for ids in by_key.values():
                    for s in range(0, len(ids), self.max_batch):
                        chunk = ids[s : s + self.max_batch]
                        waves = engine.run_prepared([flat[i] for i in chunk])
                        for i, w in zip(chunk, waves):
                            flat_waves[i] = w
        silence = np.zeros(
            int(engine.sampling_rate * silence_ms / 1000), np.float32
        )
        waves, i = [], 0
        for j, job in enumerate(jobs):
            if j:
                waves.append(silence)
            waves.extend(flat_waves[i : i + len(job)])
            i += len(job)
        audio = np.concatenate(waves) if waves else np.zeros(0, np.float32)
        return audio, engine.sampling_rate

    # ---- model management (hiyoriUI.py:437-583) ----

    def models_info(self) -> dict:
        return self.registry.info()

    def models_add(self, model_path: str, config_path: str | None) -> dict:
        if config_path is None:
            cand = os.path.join(os.path.dirname(model_path), "config.json")
            if not os.path.isfile(cand):
                return {
                    "status": 15,
                    "detail": "query没有提供config_path且没有在模型所在目录找到config.json",
                }
            config_path = cand
        try:
            mid = self.registry.init_model(model_path, config_path)
        except Exception as e:  # noqa: BLE001 - report to client
            return {"status": 16, "detail": f"模型加载失败: {e}"}
        return {"status": 0, "detail": "模型添加成功", "Data": {"model_id": mid}}

    def models_delete(self, model_id: int) -> dict:
        engine, still_loaded = self.registry.release(model_id)
        if engine is None:
            return {"status": 14, "detail": f"模型{model_id}不存在，删除失败"}
        if not still_loaded:
            # last alias dropped: retire its micro-batcher worker
            with self.lock:
                batcher = self._batchers.pop(id(engine), None)
            if batcher is not None:
                batcher.close()
        return {"status": 0, "detail": "删除成功"}

    def models_get_local(self) -> dict:
        """Scan models_dir for {config.json, *.pth / orbax ckpt} pairs."""
        out = {}
        root = self.models_dir
        if os.path.isdir(root):
            for dirpath, _dirnames, filenames in os.walk(root):
                cfgs = [f for f in filenames if f == "config.json"]
                models = sorted(
                    f for f in filenames if f.endswith(".pth") and f.startswith("G_")
                )
                if cfgs and models:
                    out[dirpath] = {
                        "config_path": os.path.join(dirpath, "config.json"),
                        "model_paths": [os.path.join(dirpath, m) for m in models],
                    }
        return {"status": 0, "detail": "success", "Data": out}

    def models_get_unloaded(self) -> dict:
        local = self.models_get_local()["Data"]
        loaded = {info["path"] for info in self.registry.models.values()}
        unloaded = {
            d: v
            for d, v in local.items()
            if not any(os.path.realpath(p) in loaded for p in v["model_paths"])
        }
        return {"status": 0, "detail": "success", "Data": unloaded}

    def status(self) -> dict:
        """Host + device metrics (hiyoriUI.py:584-618, GPUtil -> torch.cuda);
        no CUDA device gives an empty list."""
        import psutil
        import torch

        devices = []
        for i in range(torch.cuda.device_count()):
            devices.append(
                {"id": i, "platform": "cuda", "kind": torch.cuda.get_device_name(i),
                 "memory_total": torch.cuda.get_device_properties(i).total_memory,
                 "memory_allocated": torch.cuda.memory_allocated(i),
                 "memory_reserved": torch.cuda.memory_reserved(i)}
            )
        mem = psutil.virtual_memory()
        return {
            "status": 0,
            "detail": "success",
            "Data": {
                "cpu_percent": psutil.cpu_percent(),
                "memory_total": mem.total,
                "memory_available": mem.available,
                "memory_percent": mem.percent,
                "devices": devices,
            },
        }


class _Handler(BaseHTTPRequestHandler):
    service: TTSService = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet; the service has its own logger
        pass

    # ---- plumbing ----

    def _json(self, payload: dict, code: int = 200):
        body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _wav(self, audio: np.ndarray, sr: int):
        body = wav_bytes(audio, sr)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _params(self) -> dict:
        q = parse_qs(urlparse(self.path).query)
        out = {k: v[0] for k, v in q.items()}
        if self.command == "POST":
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if "application/json" in ctype:
                    out.update(json.loads(raw.decode("utf-8")))
                else:
                    out.update(
                        {k: v[0] for k, v in parse_qs(raw.decode("utf-8")).items()}
                    )
        return out

    # ---- routing ----

    def _route(self):
        path = urlparse(self.path).path.rstrip("/")
        p = self._params()
        svc = self.service
        try:
            if path == "" or path == "/index.html":
                from bert_vits2_tpu_torch.serve.webui import PAGE

                body = PAGE.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if path == "/voice":
                audio, sr = svc.voice(
                    text=p["text"],
                    model_id=int(p.get("model_id", p.get("model", 0))),
                    speaker=p.get("speaker_name") or int(p.get("speaker_id", 0)),
                    language=p.get("language", "ZH"),
                    sdp_ratio=float(p.get("sdp_ratio", 0.2)),
                    noise=float(p.get("noise", 0.667)),
                    noisew=float(p.get("noisew", 0.8)),
                    length=float(p.get("length", 1.0)),
                    auto_split=_bool(p.get("auto_split")),
                    style_text=p.get("style_text") or None,
                    style_weight=float(p.get("style_weight", 0.7)),
                    emotion=p.get("emotion"),
                    reference_audio=p.get("reference_audio"),
                )
                return self._wav(audio, sr)
            if path == "/models/info":
                return self._json(svc.models_info())
            if path == "/models/add":
                return self._json(
                    svc.models_add(p["model_path"], p.get("config_path"))
                )
            if path == "/models/delete":
                return self._json(svc.models_delete(int(p["model_id"])))
            if path == "/models/get_local":
                return self._json(svc.models_get_local())
            if path == "/models/get_unloaded":
                return self._json(svc.models_get_unloaded())
            if path == "/status":
                return self._json(svc.status())
            if path == "/tools/translate":
                from bert_vits2_tpu_torch.serve.translate import translate

                out = translate(
                    p.get("texts", p.get("text", "")),
                    to_language=p.get("to_language", "jp"),
                    app_key=p.get("app_key", svc.translate_keys[0]),
                    secret_key=p.get("secret_key", svc.translate_keys[1]),
                )
                return self._json({"status": 0, "Data": out})
            if path == "/tools/random_example":
                ex = svc.random_example(p.get("language"))
                if ex is None:
                    return self._json(
                        {"status": 17, "detail": "没有加载任何数据集"}, 404
                    )
                return self._json({"status": 0, "Data": ex})
            if path == "/tools/get_audio":
                fp = p.get("path", "")
                if not os.path.isfile(fp) or not fp.endswith(".wav"):
                    return self._json({"status": 18, "detail": "指定音频不存在"}, 404)
                with open(fp, "rb") as f:
                    body = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            return self._json({"status": 404, "detail": f"unknown path {path}"}, 404)
        except KeyError as e:
            return self._json({"status": 10, "detail": f"missing/unknown: {e}"}, 400)
        except Exception as e:  # noqa: BLE001 - surface to client
            return self._json({"status": 500, "detail": str(e)}, 500)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        self._route()

    def do_POST(self):  # noqa: N802
        self._route()


def make_server(
    registry: ModelRegistry,
    host: str = "127.0.0.1",
    port: int = 5000,
    models_dir: str = "Data",
    batching: bool = True,
    max_batch: int = 16,
    batch_delay_ms: float = 10.0,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; .serve_forever() to run."""
    service = TTSService(
        registry, models_dir=models_dir, batching=batching,
        max_batch=max_batch, batch_delay_ms=batch_delay_ms,
    )
    handler = type("BoundHandler", (_Handler,), {"service": service})

    class _Server(ThreadingHTTPServer):
        def server_close(self):  # join batcher workers, not just sockets
            service.close()
            super().server_close()

    return _Server((host, port), handler)


def engine_loader(device="cuda", allow_noise_bert: bool = True):
    """The registry's loader that main() builds: (checkpoint_path,
    config_path) -> a TTSEngine on `device` (load_tts_engine)."""
    from bert_vits2_tpu_torch.infer.loader import load_tts_engine

    return lambda mp, cp: load_tts_engine(
        cp, checkpoint_path=mp, device=device,
        allow_noise_bert=allow_noise_bert,
    )


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Bert-VITS2 HTTP API server (PyTorch/CUDA)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--models-dir", default="Data")
    ap.add_argument(
        "--model", action="append", default=[],
        help="model_path:config_path pair to preload (repeatable)",
    )
    ap.add_argument(
        "--no-batching", action="store_true",
        help="disable dynamic request micro-batching",
    )
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument(
        "--batch-delay-ms", type=float, default=10.0,
        help="max wait for batch co-riders before flushing a device call",
    )
    ap.add_argument(
        "--warmup", action="store_true",
        help="run the expected (batch, text-bucket) grid at model load so "
             "cuDNN's algorithm choice and the allocator settle before the "
             "first requests",
    )
    ap.add_argument(
        "--require-bert", action="store_true",
        help="refuse to serve with noise prosody features: error at load "
             "when a language's local BERT weights are missing "
             "(docs/WEIGHTS.md) instead of degrading with a warning",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu; cuda without a card raises",
    )
    args = ap.parse_args()

    from bert_vits2_tpu_torch.device import resolve_device

    registry = ModelRegistry(
        loader=engine_loader(resolve_device(args.device),
                             allow_noise_bert=not args.require_bert)
    )
    for pair in args.model:
        mp, _, cp = pair.partition(":")
        mid = registry.init_model(
            mp, cp or os.path.join(os.path.dirname(mp), "config.json")
        )
        engine = registry.get(mid)
        describe = getattr(engine.bert_extractor, "describe", None)
        backends = describe() if describe else type(engine.bert_extractor).__name__
        print(f"model {mid}: BERT extractors {backends}")
        if args.warmup:
            n = engine.warmup()
            print(f"model {mid}: warmed {n} graphs")
    srv = make_server(
        registry, args.host, args.port, args.models_dir,
        batching=not args.no_batching, max_batch=args.max_batch,
        batch_delay_ms=args.batch_delay_ms,
    )
    print(f"serving on http://{args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
