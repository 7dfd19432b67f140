"""Built-in browser UI (reference: webui.py's Gradio app; gradio isn't in
this image, so the UI is a single self-contained HTML page served by
serve.server at `/` that drives the same /voice + /models endpoints).

Feature parity with the reference UI surface: speaker/model pickers,
sdp_ratio / noise / noisew / length sliders, language selector incl. AUTO
and MIX markup, style text + weight, paragraph auto-split."""

from __future__ import annotations

PAGE = """<!DOCTYPE html>
<html lang="zh">
<head>
<meta charset="utf-8">
<title>Bert-VITS2 (PyTorch/CUDA)</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 760px; margin: 2rem auto;
        padding: 0 1rem; color: #222; }
 h1 { font-size: 1.3rem; }
 label { display: block; margin-top: .8rem; font-weight: 600; }
 textarea, input[type=text], select { width: 100%; box-sizing: border-box;
        padding: .45rem; border: 1px solid #bbb; border-radius: 6px; }
 textarea { min-height: 90px; }
 .row { display: flex; gap: 1rem; flex-wrap: wrap; }
 .row > div { flex: 1; min-width: 140px; }
 .slider-val { font-weight: 400; color: #666; }
 button { margin-top: 1.2rem; padding: .6rem 2rem; font-size: 1rem;
        border: 0; border-radius: 8px; background: #2563eb; color: #fff;
        cursor: pointer; }
 button:disabled { background: #9ca3af; }
 #status { margin-left: 1rem; color: #666; }
 audio { width: 100%; margin-top: 1rem; }
</style>
</head>
<body>
<h1>Bert-VITS2 (PyTorch/CUDA) — 语音合成</h1>

<label>文本 / Text
<textarea id="text">你好，欢迎使用。</textarea></label>

<div class="row">
 <div><label>模型 / Model
  <select id="model"></select></label></div>
 <div><label>说话人 / Speaker
  <select id="speaker"></select></label></div>
 <div><label>语言 / Language
  <select id="language">
   <option>ZH</option><option>JP</option><option>EN</option>
   <option>AUTO</option><option>MIX</option>
  </select></label></div>
</div>

<div class="row">
 <div><label>SDP Ratio <span class="slider-val" id="sdpv">0.2</span>
  <input type="range" id="sdp" min="0" max="1" step="0.05" value="0.2"></label></div>
 <div><label>Noise <span class="slider-val" id="noisev">0.667</span>
  <input type="range" id="noise" min="0" max="2" step="0.01" value="0.667"></label></div>
 <div><label>Noise W <span class="slider-val" id="noisewv">0.8</span>
  <input type="range" id="noisew" min="0" max="2" step="0.05" value="0.8"></label></div>
 <div><label>Length <span class="slider-val" id="lengthv">1.0</span>
  <input type="range" id="length" min="0.1" max="2" step="0.05" value="1.0"></label></div>
</div>

<div class="row">
 <div><label>风格文本 / Style text
  <input type="text" id="style_text" placeholder="(optional)"></label></div>
 <div><label>风格权重 <span class="slider-val" id="swv">0.7</span>
  <input type="range" id="style_weight" min="0" max="1" step="0.05" value="0.7"></label></div>
 <div><label><input type="checkbox" id="auto_split" style="width:auto"> 按句切分 / Auto split</label></div>
</div>

<button id="go">合成 / Synthesize</button><span id="status"></span>
<audio id="player" controls></audio>

<script>
const $ = id => document.getElementById(id);
for (const [s, v] of [["sdp","sdpv"],["noise","noisev"],["noisew","noisewv"],
                      ["length","lengthv"],["style_weight","swv"]])
  $(s).addEventListener("input", () => $(v).textContent = $(s).value);

async function loadModels() {
  const info = await (await fetch("models/info")).json();
  $("model").innerHTML = "";
  for (const [id, m] of Object.entries(info)) {
    const o = document.createElement("option");
    o.value = id; o.textContent = id + ": " + m.model_path.split("/").pop();
    o.dataset.speakers = JSON.stringify(m.speakers);
    $("model").appendChild(o);
  }
  loadSpeakers();
}
function loadSpeakers() {
  const opt = $("model").selectedOptions[0];
  $("speaker").innerHTML = "";
  if (!opt) return;
  const speakers = JSON.parse(opt.dataset.speakers || "{}");
  for (const name of Object.keys(speakers)) {
    const o = document.createElement("option");
    o.value = name; o.textContent = name;
    $("speaker").appendChild(o);
  }
}
$("model").addEventListener("change", loadSpeakers);

$("go").addEventListener("click", async () => {
  $("go").disabled = true; $("status").textContent = "synthesizing…";
  const p = new URLSearchParams({
    text: $("text").value, model_id: $("model").value,
    speaker_name: $("speaker").value, language: $("language").value,
    sdp_ratio: $("sdp").value, noise: $("noise").value,
    noisew: $("noisew").value, length: $("length").value,
    auto_split: $("auto_split").checked,
    style_weight: $("style_weight").value,
  });
  if ($("style_text").value) p.set("style_text", $("style_text").value);
  try {
    const r = await fetch("voice?" + p.toString());
    if (!r.ok) throw new Error((await r.json()).detail || r.status);
    const blob = await r.blob();
    $("player").src = URL.createObjectURL(blob);
    $("player").play();
    $("status").textContent = "done";
  } catch (e) { $("status").textContent = "error: " + e.message; }
  $("go").disabled = false;
});
loadModels();
</script>
</body>
</html>
"""
