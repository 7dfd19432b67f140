"""Dataset-preparation wizard (reference: webui_preprocess.py:18-137).

Drives the full corpus pipeline for the reference's `data/<dataset>/` layout:

    data/<name>/esd.list        rows `path|speaker|LANG|text`
    data/<name>/raw/*.wav       source audio (any rate)
    data/<name>/wavs/*.wav      -> step `resample` (44.1 kHz mono)
    data/<name>/configs/config.json  -> step `config`
    data/<name>/train.list / val.list -> step `text`
    *.bert.npy / *.spec.npy caches -> steps `bert` / `spec`

Unlike the reference (a Gradio app shelling out to four scripts), the steps
are plain functions called in-process, runnable one-by-one or as a batch:

    python -m bert_vits2_tpu_torch.preprocess.wizard -d mydataset --steps all
    python -m bert_vits2_tpu_torch.preprocess.wizard -d mydataset --serve  # browser UI

`--serve` exposes the same four buttons as the reference wizard on a stdlib
HTTP page (gradio is not installed).

Counterpart of `bert_vits2_tpu/preprocess/wizard.py`, step for step and
file for file, on the port's preprocess functions (the `bert` step writes
seeded noise features, as the JAX wizard's does). `resample` and `spec`
map over files in spawned worker processes, or in this process with
`processes=1` (`_pool.map_jobs`).
"""

from __future__ import annotations

import argparse
import json
import os

# V2.3 defaults (reference configs/config.json; SURVEY §6 table)
DEFAULT_CONFIG = {
    "train": {
        "log_interval": 200,
        "eval_interval": 1000,
        "seed": 42,
        "epochs": 1000,
        "learning_rate": 0.0002,
        "betas": [0.8, 0.99],
        "eps": 1e-09,
        "batch_size": 16,
        "bf16_run": True,
        "lr_decay": 0.99995,
        "segment_size": 16384,
        "init_lr_ratio": 1,
        "warmup_epochs": 0,
        "c_mel": 45,
        "c_kl": 1.0,
        "c_commit": 100,
        "skip_optimizer": True,
        "freeze_ZH_bert": False,
        "freeze_JP_bert": False,
        "freeze_EN_bert": False,
        "freeze_emo": False,
    },
    "data": {
        "training_files": "filelists/train.list",
        "validation_files": "filelists/val.list",
        "max_wav_value": 32768.0,
        "sampling_rate": 44100,
        "filter_length": 2048,
        "hop_length": 512,
        "win_length": 2048,
        "n_mel_channels": 128,
        "mel_fmin": 0.0,
        "mel_fmax": None,
        "add_blank": True,
        "n_speakers": 1,
        "cleaned_text": True,
        "spk2id": {},
    },
    "model": {
        "use_spk_conditioned_encoder": True,
        "use_noise_scaled_mas": True,
        "use_mel_posterior_encoder": False,
        "use_duration_discriminator": True,
        "inter_channels": 192,
        "hidden_channels": 192,
        "filter_channels": 768,
        "n_heads": 2,
        "n_layers": 6,
        "kernel_size": 3,
        "p_dropout": 0.1,
        "resblock": "1",
        "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "upsample_rates": [8, 8, 2, 2, 2],
        "upsample_initial_channel": 512,
        "upsample_kernel_sizes": [16, 16, 8, 2, 2],
        "n_layers_q": 3,
        "use_spectral_norm": False,
        "gin_channels": 512,
        "slm": {
            "model": "./slm/wavlm-base-plus",
            "sr": 16000,
            "hidden": 768,
            "nlayers": 13,
            "initial_channel": 64,
        },
    },
    "version": "2.3",
}


def get_paths(data_dir: str, data_root: str = "data") -> dict:
    start = os.path.join(data_root, data_dir)
    return {
        "start": start,
        "lbl": os.path.join(start, "esd.list"),
        "train": os.path.join(start, "train.list"),
        "val": os.path.join(start, "val.list"),
        "config": os.path.join(start, "configs", "config.json"),
        "raw": os.path.join(start, "raw"),
        "wavs": os.path.join(start, "wavs"),
        "models": os.path.join(start, "models"),
    }


def generate_config(data_dir: str, batch_size: int = 16,
                    data_root: str = "data") -> str:
    """Step 1 (webui_preprocess.py:18-38): write configs/config.json."""
    if not data_dir:
        raise ValueError("dataset name must not be empty")
    p = get_paths(data_dir, data_root)
    if os.path.isfile(p["config"]):
        with open(p["config"], encoding="utf-8") as f:
            config = json.load(f)
    else:
        config = json.loads(json.dumps(DEFAULT_CONFIG))
    config["data"]["training_files"] = p["train"].replace("\\", "/")
    config["data"]["validation_files"] = p["val"].replace("\\", "/")
    config["train"]["batch_size"] = batch_size
    os.makedirs(os.path.dirname(p["config"]), exist_ok=True)
    os.makedirs(p["models"], exist_ok=True)
    with open(p["config"], "w", encoding="utf-8") as f:
        json.dump(config, f, indent=4, ensure_ascii=False)
    return "config file written"


def resample(data_dir: str, sr: int = 44100, processes: int | None = None,
             data_root: str = "data") -> str:
    """Step 2 (webui_preprocess.py:41-58): raw/ -> wavs/ at 44.1 kHz mono."""
    from bert_vits2_tpu_torch.preprocess._pool import map_jobs
    from bert_vits2_tpu_torch.preprocess.resample import _job, resample_jobs

    p = get_paths(data_dir, data_root)
    jobs = resample_jobs(p["raw"], p["wavs"], sr)
    errors = [e for e in map_jobs(_job, jobs, processes or os.cpu_count() or 1) if e]
    for e in errors:
        print("ERROR", e)
    return f"resampled {len(jobs) - len(errors)}/{len(jobs)} files"


def preprocess_text_step(data_dir: str, data_root: str = "data") -> str:
    """Step 3 (webui_preprocess.py:61-87): rewrite esd.list paths to wavs/,
    run g2p + train/val split, update config.json spk2id."""
    from bert_vits2_tpu_torch.preprocess.text import preprocess_text

    p = get_paths(data_dir, data_root)
    with open(p["lbl"], encoding="utf-8") as f:
        lines = [ln for ln in f if ln.strip()]
    with open(p["lbl"], "w", encoding="utf-8") as f:
        for line in lines:
            path, spk, language, text = line.strip().split("|", 3)
            path = os.path.join(p["wavs"], os.path.basename(path)).replace("\\", "/")
            f.write(f"{path}|{spk}|{language}|{text}\n")
    spk2id = preprocess_text(
        p["lbl"], train_path=p["train"], val_path=p["val"], config_path=p["config"]
    )
    return f"labels processed ({len(spk2id)} speakers)"


def bert_gen_step(data_dir: str, data_root: str = "data") -> str:
    """Step 4 (webui_preprocess.py:90-94): cache .bert.npy features."""
    from bert_vits2_tpu_torch.preprocess.bert_gen import bert_gen

    p = get_paths(data_dir, data_root)
    n = sum(bert_gen(fl) for fl in (p["train"], p["val"]))
    return f"cached {n} BERT feature files"


def spec_gen_step(data_dir: str, data_root: str = "data",
                  processes: int = 8) -> str:
    """Extra step (ours): cache .spec.npy so training never computes STFTs."""
    from bert_vits2_tpu_torch.preprocess.spec_gen import spec_gen

    p = get_paths(data_dir, data_root)
    with open(p["config"], encoding="utf-8") as f:
        d = json.load(f)["data"]
    for fl in (p["train"], p["val"]):
        spec_gen(fl, d["filter_length"], d["hop_length"], d["win_length"], processes)
    return "spectrogram caches written"


STEPS = {
    "config": generate_config,
    "resample": resample,
    "text": preprocess_text_step,
    "bert": bert_gen_step,
    "spec": spec_gen_step,
}
_ORDER = ("config", "resample", "text", "bert", "spec")

_PAGE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Bert-VITS2 — dataset wizard</title>
<style>body{font-family:system-ui;max-width:640px;margin:2rem auto;padding:0 1rem}
button{display:block;margin:.5rem 0;padding:.5rem 1.5rem}</style></head><body>
<h1>Dataset preprocessing</h1>
<p>Layout: <code>data/&lt;name&gt;/esd.list</code> + <code>data/&lt;name&gt;/raw/*.wav</code></p>
<label>Dataset name <input id="d" value=""></label>
<label>Batch size <input id="b" value="16" size="4"></label>
<div id="buttons"></div><pre id="log"></pre>
<script>
const steps=["config","resample","text","bert","spec"];
const bt=document.getElementById("buttons");
steps.forEach(s=>{const b=document.createElement("button");b.textContent="Run: "+s;
b.onclick=async()=>{const r=await fetch(`/api/step?name=${s}&dataset=`+
encodeURIComponent(document.getElementById("d").value)+`&batch_size=`+
document.getElementById("b").value);document.getElementById("log").textContent+=
s+": "+await r.text()+"\\n";};bt.appendChild(b);});
</script></body></html>"""


def serve(port: int = 7860, data_root: str = "data"):
    """Browser wizard — same four buttons as the reference's Gradio app."""
    server = make_server(port, data_root)
    print(f"wizard at http://127.0.0.1:{server.server_address[1]}/")
    server.serve_forever()


def make_server(port: int = 7860, data_root: str = "data", host: str = "0.0.0.0"):
    """The wizard's HTTP server, bound and not yet serving (port 0: a free
    one, read back from `server_address`)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path in ("/", "/index.html"):
                body = _PAGE.encode()
                ctype = "text/html; charset=utf-8"
            elif u.path == "/api/step":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                name = q.get("name", "")
                try:
                    kw = {"data_root": data_root}
                    if name == "config":
                        kw["batch_size"] = int(q.get("batch_size", 16))
                    body = STEPS[name](q.get("dataset", ""), **kw).encode()
                except Exception as e:  # noqa: BLE001
                    body = f"ERROR: {e}".encode()
                ctype = "text/plain; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def main():
    ap = argparse.ArgumentParser(description="Dataset preprocessing wizard")
    ap.add_argument("-d", "--dataset", default="")
    ap.add_argument("--steps", default="all",
                    help=f"comma list of {_ORDER} or 'all'")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--serve", action="store_true", help="browser wizard")
    ap.add_argument("--port", type=int, default=7860)
    args = ap.parse_args()
    if args.serve:
        serve(args.port, args.data_root)
        return
    names = _ORDER if args.steps == "all" else tuple(args.steps.split(","))
    for name in names:
        kw = {"data_root": args.data_root}
        if name == "config":
            kw["batch_size"] = args.batch_size
        print(f"[{name}]", STEPS[name](args.dataset, **kw))


if __name__ == "__main__":
    main()
