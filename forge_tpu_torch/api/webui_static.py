# Copied from forge_tpu/api/webui_static.py (INDEX_HTML, served as it is).
"""The built-in web UI: a single-page app over the REST API.

The functional twin of the reference's Gradio app (modules/ui.py:271
create_ui, modules_forge/main_entry.py top bar, javascript/ modules) built
as dependency-free vanilla HTML/JS served from this process: txt2img /
img2img(+inpaint brush) / Extras / PNG Info / Settings tabs, full generation
controls (sampler/scheduler/steps/CFG/size/batch/seed+subseed/clip-skip),
hires-fix + refiner + ControlNet sections, progress polling with live
preview, gallery with infotext, send-to buttons, and an options editor.
"""

INDEX_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>forge-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root{
  --bg:#111418;--panel:#1a1f26;--panel2:#232a33;--border:#303945;
  --text:#d7dde4;--dim:#8a94a0;--accent:#e8833a;--accent2:#4a90d9;
  --ok:#4caf7d;--err:#d9534f;
}
*{box-sizing:border-box}
body{margin:0;background:var(--bg);color:var(--text);
  font:14px/1.45 system-ui,-apple-system,"Segoe UI",sans-serif}
header{display:flex;align-items:center;gap:16px;padding:8px 16px;
  background:var(--panel);border-bottom:1px solid var(--border)}
header h1{font-size:16px;margin:0;color:var(--accent);letter-spacing:.5px}
header .model-select{display:flex;align-items:center;gap:6px;flex:1}
select,input[type=text],input[type=number],textarea{
  background:var(--panel2);color:var(--text);border:1px solid var(--border);
  border-radius:4px;padding:5px 8px;font:inherit}
textarea{width:100%;resize:vertical;min-height:58px}
input[type=range]{accent-color:var(--accent)}
button{background:var(--panel2);color:var(--text);border:1px solid var(--border);
  border-radius:4px;padding:6px 14px;cursor:pointer;font:inherit}
button:hover{border-color:var(--accent)}
button.primary{background:var(--accent);border-color:var(--accent);color:#111;font-weight:600}
button.danger{border-color:var(--err);color:var(--err)}
nav.tabs{display:flex;gap:2px;background:var(--panel);padding:0 16px}
nav.tabs button{border:none;border-radius:6px 6px 0 0;background:transparent;
  color:var(--dim);padding:9px 18px}
nav.tabs button.active{background:var(--bg);color:var(--text)}
main{padding:14px 16px}
.tab{display:none}.tab.active{display:block}
.cols{display:flex;gap:14px;align-items:flex-start;flex-wrap:wrap}
.col-l{flex:1 1 520px;min-width:420px}
.col-r{flex:1 1 420px;min-width:380px}
/* mobile layout (reference extensions-builtin/mobile/mobile.js intent):
   single column, finger-sized controls */
@media (max-width:700px){
  .col-l,.col-r{min-width:100%;flex-basis:100%}
  button{min-height:38px}
  nav button{padding:.5em .7em}
  input[type=range]{min-height:28px}
}
fieldset{border:1px solid var(--border);border-radius:6px;margin:0 0 10px;
  padding:10px 12px;background:var(--panel)}
legend{color:var(--dim);padding:0 6px;font-size:12px;text-transform:uppercase;
  letter-spacing:.8px}
.row{display:flex;gap:10px;align-items:center;margin:6px 0;flex-wrap:wrap}
.row label{color:var(--dim);min-width:86px;font-size:13px}
.row .val{min-width:40px;text-align:right;color:var(--accent)}
.grow{flex:1}
.gallery{display:flex;flex-wrap:wrap;gap:8px;margin-top:8px}
.gallery img{max-width:168px;border:1px solid var(--border);border-radius:4px;cursor:pointer}
.gallery img.sel{border-color:var(--accent)}
#preview-box{position:relative;min-height:220px;background:var(--panel);
  border:1px solid var(--border);border-radius:6px;display:flex;
  align-items:center;justify-content:center;overflow:hidden}
#preview-box img{max-width:100%;max-height:540px}
#progress-wrap{height:6px;background:var(--panel2);border-radius:3px;margin:8px 0;overflow:hidden}
#progress-bar{height:100%;width:0%;background:var(--accent);transition:width .3s}
#infotext{white-space:pre-wrap;color:var(--dim);font-size:12px;margin-top:6px;
  font-family:ui-monospace,monospace}
.drop{border:2px dashed var(--border);border-radius:6px;min-height:140px;
  display:flex;align-items:center;justify-content:center;color:var(--dim);
  position:relative;overflow:hidden}
.drop img{max-width:100%;max-height:320px;display:block}
.drop.over{border-color:var(--accent)}
#mask-canvas{position:absolute;left:0;top:0;cursor:crosshair}
.kv{display:grid;grid-template-columns:240px 1fr;gap:6px 14px;align-items:center}
.kv label{color:var(--dim);font-size:13px;text-align:right}
.toast{position:fixed;bottom:18px;right:18px;background:var(--panel2);
  border:1px solid var(--accent);border-radius:6px;padding:10px 16px;display:none}
.small{font-size:12px;color:var(--dim)}
.ta-wrap{position:relative}
.tokcount{position:absolute;right:6px;bottom:6px;font-size:11px;color:var(--dim);
  background:var(--panel2);border:1px solid var(--border);border-radius:4px;
  padding:1px 5px;pointer-events:auto}
.tokcount.error{color:var(--err);border-color:var(--err)}
details{margin:4px 0}
details>summary{cursor:pointer;color:var(--dim)}
.cards{display:grid;grid-template-columns:repeat(auto-fill,minmax(150px,1fr));
  gap:10px;margin-top:10px}
.card{background:var(--panel2);border-radius:8px;overflow:hidden;cursor:pointer;
  border:1px solid transparent;position:relative}
.card:hover{border-color:var(--accent)}
.card .thumb{width:100%;aspect-ratio:1;object-fit:cover;display:block;
  background:var(--panel)}
.card .thumb.ph{display:flex;align-items:center;justify-content:center;
  font-size:34px;color:var(--muted)}
.card .cname{padding:6px 8px;font-size:12px;word-break:break-all}
.card .cdesc{padding:0 8px 6px;font-size:11px;color:var(--muted)}
.card .edit{position:absolute;top:6px;right:6px;background:var(--panel);
  border:none;border-radius:4px;cursor:pointer;padding:2px 6px}
#net-kinds button{margin-right:4px}
#net-kinds button.active{background:var(--accent);color:#fff}
#net-dirs button{margin:2px 4px 2px 0}
#net-dirs button.active{background:var(--accent);color:#fff}
.modal{position:fixed;inset:0;background:#0009;display:none;z-index:40;
  align-items:center;justify-content:center}
.modal .box{background:var(--panel);border-radius:10px;padding:18px;
  min-width:340px;max-width:520px}
.modal .box label{display:block;margin-top:8px;font-size:12px;color:var(--muted)}
.modal .box input,.modal .box textarea{width:100%}
#lightbox{position:fixed;inset:0;background:#000c;display:none;
  align-items:center;justify-content:center;z-index:50}
#lightbox img{max-width:94vw;max-height:92vh}
</style>
</head>
<body>
<header>
  <h1>forge-tpu</h1>
  <div class="model-select">
    <label class="small">Checkpoint</label>
    <select id="sd-model" style="min-width:260px"></select>
    <button id="refresh-models" title="Refresh">&#10227;</button>
    <span id="model-status" class="small"></span>
  </div>
  <span class="small" id="mem-status"></span>
</header>
<nav class="tabs">
  <button data-tab="txt2img" class="active">txt2img</button>
  <button data-tab="img2img">img2img</button>
  <button data-tab="extras">Extras</button>
  <button data-tab="pnginfo">PNG Info</button>
  <button data-tab="networks">Networks</button>
  <button data-tab="xyz">X/Y/Z</button>
  <button data-tab="merge">Merge</button>
  <button data-tab="extensions">Extensions</button>
  <button data-tab="spaces">Spaces</button>
  <button data-tab="settings">Settings</button>
</nav>
<main>

<!-- ===================== txt2img + img2img (shared template) ============ -->
<div class="tab active" id="tab-txt2img"></div>
<div class="tab" id="tab-img2img"></div>

<!-- ===================== Extras ========================================= -->
<div class="tab" id="tab-extras">
  <div class="cols">
    <div class="col-l">
      <fieldset><legend>Input</legend>
        <div class="drop" id="extras-drop">drop / paste image here</div>
      </fieldset>
      <fieldset><legend>Upscale</legend>
        <div class="row"><label>Upscaler</label>
          <select id="extras-upscaler" class="grow"></select></div>
        <div class="row"><label>Scale</label>
          <input type="range" id="extras-scale" min="1" max="4" step="0.25" value="2">
          <span class="val" id="extras-scale-v">2</span></div>
        <button class="primary" id="extras-run">Upscale</button>
      </fieldset>
    </div>
    <div class="col-r">
      <fieldset><legend>Result</legend><div id="extras-out" class="gallery"></div></fieldset>
    </div>
  </div>
</div>

<!-- ===================== PNG Info ======================================= -->
<div class="tab" id="tab-pnginfo">
  <div class="cols">
    <div class="col-l">
      <fieldset><legend>Image</legend>
        <div class="drop" id="pnginfo-drop">drop a generated PNG here</div>
      </fieldset>
    </div>
    <div class="col-r">
      <fieldset><legend>Parameters</legend>
        <pre id="pnginfo-out" style="white-space:pre-wrap"></pre>
        <button id="pnginfo-send">Send to txt2img</button>
      </fieldset>
    </div>
  </div>
</div>

<!-- ===================== X/Y/Z plot ===================================== -->
<div class="tab" id="tab-xyz">
  <div class="cols">
    <div class="col-l">
      <fieldset><legend>Base generation</legend>
        <div class="row"><label>Prompt</label>
          <textarea id="xyz-prompt" rows="2" class="grow"></textarea></div>
        <div class="row"><label>Steps</label>
          <input type="number" id="xyz-steps" value="20" style="width:5em">
          <label>Size</label>
          <input type="number" id="xyz-w" value="512" style="width:5em">x<input
            type="number" id="xyz-h" value="512" style="width:5em"></div>
      </fieldset>
      <fieldset><legend>Axes (comma-separated values)</legend>
        <div class="row"><label>X</label>
          <select id="xyz-xf"></select>
          <input id="xyz-xv" class="grow" placeholder="e.g. 1,2,3"></div>
        <div class="row"><label>Y</label>
          <select id="xyz-yf"></select>
          <input id="xyz-yv" class="grow" placeholder="(optional)"></div>
        <div class="row"><label>Z</label>
          <select id="xyz-zf"></select>
          <input id="xyz-zv" class="grow" placeholder="(optional)"></div>
        <div class="row"><label>S/R search</label>
          <input id="xyz-sr" class="grow"
            placeholder="substring for Prompt S/R axes"></div>
        <button class="primary" id="xyz-run">Generate grid</button>
        <span class="small" id="xyz-status"></span>
      </fieldset>
    </div>
    <div class="col-r">
      <fieldset><legend>Grids</legend><div id="xyz-out" class="gallery"></div></fieldset>
    </div>
  </div>
</div>

<!-- ===================== Checkpoint merger ============================== -->
<div class="tab" id="tab-merge">
  <fieldset><legend>Merge checkpoints</legend>
    <div class="row"><label>Primary (A)</label><select id="merge-a" class="grow"></select></div>
    <div class="row"><label>Secondary (B)</label><select id="merge-b" class="grow"></select></div>
    <div class="row"><label>Tertiary (C)</label><select id="merge-c" class="grow"></select></div>
    <div class="row"><label>Method</label>
      <select id="merge-mode">
        <option value="weighted_sum">Weighted sum (A·(1−M) + B·M)</option>
        <option value="add_difference">Add difference (A + (B−C)·M)</option>
        <option value="no_interpolation">No interpolation (A)</option>
      </select></div>
    <div class="row"><label>Multiplier M</label>
      <input type="range" id="merge-m" min="0" max="1" step="0.05" value="0.3">
      <span class="val" id="merge-m-v">0.3</span></div>
    <div class="row"><label>Output name</label>
      <input id="merge-name" class="grow" value="merged"></div>
    <button class="primary" id="merge-run">Merge</button>
    <span class="small" id="merge-status"></span>
  </fieldset>
</div>

<!-- ===================== Extensions ===================================== -->
<div class="tab" id="tab-extensions">
  <fieldset><legend>Installed extensions</legend>
    <table style="width:100%;border-collapse:collapse" id="ext-table"></table>
  </fieldset>
  <fieldset><legend>Config states</legend>
    <div class="row">
      <input id="cfgstate-name" placeholder="snapshot name">
      <button id="cfgstate-save">Save current config state</button>
    </div>
    <div id="cfgstate-list" class="small"></div>
  </fieldset>
</div>

<!-- ===================== Spaces ========================================= -->
<!-- ===================== Extra-networks browser ========================= -->
<div class="tab" id="tab-networks">
  <fieldset><legend>Extra networks</legend>
    <div class="row">
      <span id="net-kinds">
        <button data-kind="lora" class="active">Lora</button>
        <button data-kind="ti">Textual Inversion</button>
        <button data-kind="hypernet">Hypernetworks</button>
        <button data-kind="checkpoint">Checkpoints</button>
      </span>
      <input id="net-search" class="grow" placeholder="search networks…">
      <button id="net-refresh" title="Rescan directories">&#10227;</button>
    </div>
    <div class="row small" id="net-dirs"></div>
    <div id="net-cards" class="cards"></div>
    <div class="small" id="net-empty" style="display:none">
      nothing found — put files under models/Lora, embeddings/,
      models/hypernetworks or models/Stable-diffusion</div>
  </fieldset>
</div>

<div class="tab" id="tab-spaces">
  <fieldset><legend>Forge Spaces</legend>
    <div id="spaces-list" class="kv"></div>
    <div class="small" id="spaces-empty" style="display:none">
      no spaces installed — drop a folder with space_meta.json + forge_app.py
      under extensions/</div>
  </fieldset>
</div>

<!-- ===================== Settings ======================================= -->
<div class="tab" id="tab-settings">
  <fieldset><legend>Options</legend>
    <div class="kv" id="settings-grid"></div>
    <div class="row" style="margin-top:10px">
      <button class="primary" id="settings-save">Apply settings</button>
      <span id="settings-status" class="small"></span>
    </div>
  </fieldset>
  <fieldset><legend>Server</legend>
    <button class="danger" id="server-stop">Stop server</button>
  </fieldset>
</div>

</main>
<div class="toast" id="toast"></div>
<div id="lightbox"><img id="lightbox-img"></div>
<div class="modal" id="net-modal">
  <div class="box">
    <h3 id="net-modal-title" style="margin-top:0"></h3>
    <label>Description</label><textarea id="net-md-desc" rows="2"></textarea>
    <label>Activation text (appended on insert)</label>
    <input id="net-md-act">
    <label>Preferred weight (0 = default 1.0)</label>
    <input id="net-md-weight" type="number" step="0.05" min="-2" max="2">
    <label>Notes</label><textarea id="net-md-notes" rows="3"></textarea>
    <div class="row" style="margin-top:12px">
      <button class="primary" id="net-md-save">Save</button>
      <button id="net-md-cancel">Cancel</button>
    </div>
  </div>
</div>

<script>
"use strict";
const $=(s,el)=>(el||document).querySelector(s);
const $$=(s,el)=>[...(el||document).querySelectorAll(s)];
const api=async(path,body)=>{
  const r=await fetch(path,body?{method:"POST",headers:{"Content-Type":"application/json"},
    body:JSON.stringify(body)}:{});
  if(!r.ok){const d=await r.json().catch(()=>({detail:r.statusText}));
    throw new Error(d.detail||r.statusText);}
  return r.json();
};
const toast=(msg,ok)=>{const t=$("#toast");t.textContent=msg;
  t.style.borderColor=ok===false?"var(--err)":"var(--accent)";
  t.style.display="block";clearTimeout(t._h);t._h=setTimeout(()=>t.style.display="none",3500);};

/* ------- tabs ------- */
$$("nav.tabs button").forEach(b=>b.onclick=()=>{
  $$("nav.tabs button").forEach(x=>x.classList.remove("active"));
  $$(".tab").forEach(x=>x.classList.remove("active"));
  b.classList.add("active");$("#tab-"+b.dataset.tab).classList.add("active");
});

/* ------- generation panel template (txt2img & img2img) ------- */
function sliderRow(id,label,min,max,step,val){
  return `<div class="row"><label>${label}</label>
    <input type="range" class="grow" id="${id}" min="${min}" max="${max}" step="${step}" value="${val}"
      oninput="document.getElementById('${id}-v').textContent=this.value">
    <span class="val" id="${id}-v">${val}</span></div>`;
}
function genPanel(mode){
  const m=mode;
  const img2img = m==="img2img" ? `
  <fieldset><legend>Source image</legend>
    <div class="drop" id="${m}-drop">drop / paste the init image</div>
    <div class="row"><label>Inpaint</label>
      <button id="${m}-mask-toggle">Enable mask brush</button>
      <button id="${m}-mask-clear">Clear mask</button>
      <label>Brush</label><input type="range" id="${m}-brush" min="4" max="80" value="24" style="width:90px">
    </div>
    ${sliderRow(m+"-denoise","Denoising",0,1,0.01,0.75)}
    <div class="row"><label>Fill mode</label>
      <select id="${m}-fill"><option>original</option><option>fill</option>
      <option value="latent_noise">latent noise</option><option value="latent_nothing">latent nothing</option></select>
      <label>Mask blur</label><input type="number" id="${m}-maskblur" value="4" style="width:64px">
      <label><input type="checkbox" id="${m}-fullres"> only masked</label>
    </div>
  </fieldset>`:"";
  return `<div class="cols"><div class="col-l">
  <fieldset><legend>Prompt</legend>
    <div class="ta-wrap">
      <textarea id="${m}-prompt" placeholder="prompt — supports (emphasis:1.2), [a:b:0.5] editing, AND, <lora:name:w>"></textarea>
      <span class="tokcount" id="${m}-prompt-count">-/75</span>
    </div>
    <div class="ta-wrap">
      <textarea id="${m}-negative" placeholder="negative prompt" style="min-height:40px"></textarea>
      <span class="tokcount" id="${m}-negative-count">-/75</span>
    </div>
    <div class="row"><label>Styles</label>
      <select id="${m}-styles" multiple size="1" class="grow" title="ctrl-click to select multiple styles"></select>
      <button id="${m}-style-save" title="Save current prompts as a style">&#128190;</button>
      <button id="${m}-paste" title="Read generation parameters from the prompt box into the form">&#8601;</button>
    </div>
    <details><summary>Extra networks</summary>
      <div class="row small" id="${m}-networks">no LoRAs / embeddings found</div>
    </details>
  </fieldset>
  ${img2img}
  <fieldset><legend>Sampling</legend>
    <div class="row">
      <label>Sampler</label><select id="${m}-sampler" class="grow"></select>
      <label>Schedule</label><select id="${m}-scheduler"></select>
    </div>
    ${sliderRow(m+"-steps","Steps",1,150,1,20)}
    ${sliderRow(m+"-cfg","CFG scale",1,30,0.5,7)}
    <div class="row">
      <label>Width</label><input type="number" id="${m}-width" value="512" step="64" min="64" style="width:84px">
      <label>Height</label><input type="number" id="${m}-height" value="512" step="64" min="64" style="width:84px">
      <label>Batch</label><input type="number" id="${m}-batch" value="1" min="1" max="8" style="width:64px">
      <label>Iter</label><input type="number" id="${m}-niter" value="1" min="1" max="16" style="width:64px">
    </div>
    <div class="row">
      <label>Seed</label><input type="number" id="${m}-seed" value="-1" style="width:140px">
      <button onclick="document.getElementById('${m}-seed').value=-1">&#127922;</button>
      <button id="${m}-reuse-seed" title="Reuse last seed">&#9851;</button>
      <label>Clip skip</label><input type="number" id="${m}-clipskip" value="1" min="1" max="12" style="width:56px">
    </div>
    <details><summary>Variation seed</summary>
      <div class="row"><label>Subseed</label><input type="number" id="${m}-subseed" value="-1" style="width:140px">
      ${sliderRow(m+"-substrength","Strength",0,1,0.01,0)}</div>
    </details>
    <details id="${m}-extraopts" class="row small" style="display:none"></details>
    <div class="row"><label>Script</label>
      <select id="${m}-script"><option value="">None</option></select></div>
    <div class="row small" id="${m}-script-args" style="display:none"></div>
  </fieldset>
  ${m==="txt2img"?`
  <fieldset><legend><label><input type="checkbox" id="${m}-hr-enable"> Hires. fix</label></legend>
    <div class="row">
      <label>Upscaler</label><select id="${m}-hr-upscaler"><option>Latent</option></select>
      ${""}
      <label>Scale</label><input type="number" id="${m}-hr-scale" value="2" step="0.25" min="1" max="4" style="width:64px">
      <label>Steps</label><input type="number" id="${m}-hr-steps" value="0" min="0" style="width:64px">
    </div>
    ${sliderRow(m+"-hr-denoise","HR denoise",0,1,0.01,0.7)}
    <div class="row"><label>HR model</label><select id="${m}-hr-model"><option value="">(same)</option></select></div>
  </fieldset>
  <fieldset><legend>Refiner</legend>
    <div class="row">
      <label>Checkpoint</label><select id="${m}-refiner"><option value="">(none)</option></select>
      ${sliderRow(m+"-refiner-at","Switch at",0.05,0.95,0.05,0.8)}
    </div>
  </fieldset>`:""}
  <fieldset><legend><label><input type="checkbox" id="${m}-cn-enable"> ControlNet</label></legend>
    <div class="row"><label>Image</label></div>
    <div class="drop" id="${m}-cn-drop" style="min-height:90px">control image</div>
    <div class="row">
      <label>Module</label><select id="${m}-cn-module"></select>
      <label>Model</label><select id="${m}-cn-model"></select>
    </div>
    ${sliderRow(m+"-cn-weight","Weight",0,2,0.05,1)}
    <div class="row">
      ${sliderRow(m+"-cn-start","Start",0,1,0.05,0)}
      ${sliderRow(m+"-cn-end","End",0,1,0.05,1)}
    </div>
  </fieldset>
  </div>
  <div class="col-r">
    <div class="row">
      <button class="primary grow" id="${m}-generate" style="padding:12px">Generate</button>
      <button id="${m}-interrupt" class="danger">Interrupt</button>
      <button id="${m}-skip">Skip</button>
    </div>
    <div id="progress-wrap-${m}" style="height:6px;background:var(--panel2);border-radius:3px;margin:8px 0;overflow:hidden">
      <div id="progress-bar-${m}" style="height:100%;width:0%;background:var(--accent)"></div></div>
    <div id="preview-box" class="pv-${m}"><span class="small">output appears here</span></div>
    <div class="gallery" id="${m}-gallery"></div>
    <div id="infotext" class="it-${m}"></div>
    <div class="row" style="margin-top:6px">
      <button id="${m}-send-i2i">Send to img2img</button>
      <button id="${m}-send-extras">Send to extras</button>
    </div>
  </div></div>`;
}
$("#tab-txt2img").innerHTML=genPanel("txt2img");
$("#tab-img2img").innerHTML=genPanel("img2img");

/* ------- populate dropdowns ------- */
const stateImgs={txt2img:{imgs:[],infos:[],sel:0,lastSeed:-1},img2img:{imgs:[],infos:[],sel:0,lastSeed:-1}};
async function loadLists(){
  try{
    const [samplers,scheds,models,upscalers,cnmods,cnmodels]=await Promise.all([
      api("/sdapi/v1/samplers"),api("/sdapi/v1/schedulers"),api("/sdapi/v1/sd-models"),
      api("/sdapi/v1/upscalers"),api("/controlnet/module_list"),api("/controlnet/model_list")]);
    for(const m of ["txt2img","img2img"]){
      $(`#${m}-sampler`).innerHTML=samplers.map(s=>`<option>${s.name}</option>`).join("");
      $(`#${m}-scheduler`).innerHTML=scheds.map(s=>`<option value="${s.name}">${s.label}</option>`).join("");
      $(`#${m}-cn-module`).innerHTML=cnmods.module_list.map(x=>`<option>${x}</option>`).join("");
      $(`#${m}-cn-model`).innerHTML=["<option value=''>(none)</option>",
        ...cnmodels.model_list.map(x=>`<option>${x}</option>`)].join("");
    }
    $("#sd-model").innerHTML=models.map(x=>`<option value="${x.title}">${x.title}</option>`).join("");
    const upsOpts=upscalers.map(u=>`<option>${u.name}</option>`).join("");
    $("#extras-upscaler").innerHTML=upsOpts;
    $("#txt2img-hr-upscaler").innerHTML="<option>Latent</option>"+upsOpts;
    $("#txt2img-hr-model").innerHTML="<option value=''>(same)</option>"+
      models.map(x=>`<option>${x.title}</option>`).join("");
    $("#txt2img-refiner").innerHTML="<option value=''>(none)</option>"+
      models.map(x=>`<option>${x.title}</option>`).join("");
    const o=await api("/sdapi/v1/options");
    if(o.sd_model_checkpoint)$("#sd-model").value=o.sd_model_checkpoint;
    try{
      const sinfo=await api("/sdapi/v1/script-info");
      window._scriptInfo=sinfo.filter(x=>!x.is_alwayson);
      for(const m of ["txt2img","img2img"]){
        const sel=$(`#${m}-script`);
        const opts=window._scriptInfo.filter(x=>m==="img2img"||!x.is_img2img);
        const names=[...new Set(opts.map(x=>x.name))];
        sel.innerHTML="<option value=''>None</option>"+names.map(n=>`<option>${n}</option>`).join("");
        sel.onchange=()=>{
          const box=$(`#${m}-script-args`);
          const info=window._scriptInfo.find(x=>x.name===sel.value);
          if(!info||!info.args.length){box.style.display="none";box.innerHTML="";return;}
          box.style.display="";
          box.innerHTML=info.args.map(a=>{
            if(a.type==="none")return `<input type=hidden data-sarg value="">`;
            if(a.type==="bool")return `<label>${a.name} <input type=checkbox data-sarg ${a.default?"checked":""}></label>`;
            if(a.type==="int"||a.type==="float")return `<label>${a.name} <input type=number step=any data-sarg value="${a.default}" style="width:80px"></label>`;
            if(a.type==="choice")return `<label>${a.name} <select data-sarg>${a.choices.map(c=>`<option${c===a.default?" selected":""}>${c}</option>`).join("")}</select></label>`;
            if(a.type==="multi")return `<label>${a.name} <select data-sarg multiple size=2 data-multi>${a.choices.map(c=>`<option${(a.default||[]).includes(c)?" selected":""}>${c}</option>`).join("")}</select></label>`;
            return `<label>${a.name} <textarea data-sarg rows=2 style="width:100%">${a.default||""}</textarea></label>`;
          }).join(" ");
        };
      }
    }catch(e){}
    for(const m of ["txt2img","img2img"]){
      /* extra-options-section equivalent (reference extensions-builtin/
         extra-options-section): quick option controls, sent per-request
         as override_settings */
      const names=String(o["extra_options_"+m]||"").split(",").map(x=>x.trim()).filter(Boolean);
      const box=$(`#${m}-extraopts`);if(!box)continue;
      if(!names.length){box.style.display="none";continue;}
      box.style.display="";
      box.innerHTML="<summary>Options</summary>"+names.map(n=>{
        const v=o[n];
        if(typeof v==="boolean")return `<label>${n} <input type=checkbox data-opt="${n}" ${v?"checked":""}></label>`;
        if(typeof v==="number")return `<label>${n} <input type=number step=any data-opt="${n}" value="${v}" style="width:90px"></label>`;
        return `<label>${n} <input type=text data-opt="${n}" value="${v??""}" style="width:140px"></label>`;
      }).join(" ");
    }
  }catch(e){toast("list load failed: "+e.message,false);}
  loadStyles();
}
async function loadStyles(){
  try{
    const styles=await api("/sdapi/v1/prompt-styles");
    for(const m of ["txt2img","img2img"]){
      const sel=$(`#${m}-styles`);const prev=[...sel.selectedOptions].map(o=>o.value);
      sel.innerHTML=styles.map(s=>`<option${prev.includes(s.name)?" selected":""}>${s.name}</option>`).join("");
    }
  }catch(e){}
}
/* localization: swap visible strings per the selected dictionary
   (reference javascript/localization.js, applied once after first render) */
(async()=>{try{
  const loc=await api("/sdapi/v1/localization");
  const dict=loc.data||{};if(!Object.keys(dict).length)return;
  const walk=n=>{for(const c of n.childNodes){
    if(c.nodeType===3&&dict[c.nodeValue.trim()])
      c.nodeValue=c.nodeValue.replace(c.nodeValue.trim(),dict[c.nodeValue.trim()]);
    else if(c.nodeType===1)walk(c);}};
  walk(document.body);
  $$("[placeholder]").forEach(el=>{if(dict[el.placeholder])el.placeholder=dict[el.placeholder];});
  $$("[title]").forEach(el=>{if(dict[el.title])el.title=dict[el.title];});
}catch(e){}})();
loadLists();
$("#refresh-models").onclick=async()=>{await api("/sdapi/v1/refresh-checkpoints",{});loadLists();};

/* ------- extra-networks browser (lora/embedding chips → prompt) ------- */
async function loadNetworks(){
  let chips=[];
  try{
    const loras=await api("/sdapi/v1/loras");
    chips=chips.concat((loras||[]).map(l=>({label:l.name,ins:`<lora:${l.name}:1>`})));
  }catch(e){}
  try{
    const emb=await api("/sdapi/v1/embeddings");
    chips=chips.concat(Object.keys((emb&&emb.loaded)||{}).map(n=>({label:n,ins:n})));
  }catch(e){}
  for(const m of ["txt2img","img2img"]){
    const box=$(`#${m}-networks`);
    if(!box)continue;
    if(!chips.length){box.textContent="no LoRAs / embeddings found";continue;}
    box.innerHTML=chips.map((c,i)=>
      `<button data-net="${i}" title="insert into prompt">${c.label}</button>`+
      (c.ins.startsWith("<lora:")?`<button data-meta="${c.label}" title="edit metadata"
         class="small">ⓘ</button>`:"")).join(" ");
    $$(`#${m}-networks [data-net]`).forEach(b=>b.onclick=async()=>{
      const t=$(`#${m}-prompt`); const c=chips[+b.dataset.net];
      let ins=c.ins;
      if(ins.startsWith("<lora:")){
        try{const md=await api(`/sdapi/v1/extra-networks/metadata?name=${encodeURIComponent(c.label)}`);
          const w=md["preferred weight"];
          if(w)ins=`<lora:${c.label}:${w}>`;
          if(md["activation text"])ins+=", "+md["activation text"];
        }catch(e){}
      }
      t.value=(t.value?t.value+", ":"")+ins;
    });
    $$(`#${m}-networks [data-meta]`).forEach(b=>b.onclick=async()=>{
      const name=b.dataset.meta;
      const md=await api(`/sdapi/v1/extra-networks/metadata?name=${encodeURIComponent(name)}`);
      const desc=prompt(`${name} — description`,md.description||"");
      if(desc===null)return;
      const act=prompt(`${name} — activation text (appended on insert)`,
                       md["activation text"]||"");
      if(act===null)return;
      const w=prompt(`${name} — preferred weight (0 = default 1)`,
                     md["preferred weight"]||0);
      if(w===null)return;
      await api("/sdapi/v1/extra-networks/metadata",
        {name,description:desc,"activation text":act,"preferred weight":+w,
         notes:md.notes||""});
      toast("metadata saved");
    });
  }
}
loadNetworks();

/* ------- edit-attention: ctrl+up/down adjusts (text:1.1) emphasis around
   the cursor (reference javascript/edit-attention.js) ------- */
function editAttention(ta,delta){
  const text=ta.value;let s=ta.selectionStart,e=ta.selectionEnd;
  if(s===e){ // no selection: use enclosing (...) group, else word at cursor
    let open=-1,depth=0;
    for(let i=s-1;i>=0;i--){const c=text[i];
      if(c===")")depth++;else if(c==="("){if(depth===0){open=i;break}depth--;}}
    let close=-1;depth=0;
    for(let i=e;i<text.length;i++){const c=text[i];
      if(c==="(")depth++;else if(c===")"){if(depth===0){close=i;break}depth--;}}
    if(open>=0&&close>=0){s=open;e=close+1;}
    else{ // word boundaries
      while(s>0&&!/[\s,()]/.test(text[s-1]))s--;
      while(e<text.length&&!/[\s,()]/.test(text[e]))e++;
      if(s===e)return;
    }
  }
  let frag=text.slice(s,e),weight=1.0,inner=frag;
  const m=frag.match(/^\(([\s\S]*):([\d.]+)\)$/);
  if(m){inner=m[1];weight=parseFloat(m[2]);}
  else if(/^\([\s\S]*\)$/.test(frag)){inner=frag.slice(1,-1);weight=1.1;}
  weight=Math.max(0,Math.round((weight+delta)*100)/100);
  const rep=Math.abs(weight-1.0)<1e-9?inner:`(${inner}:${weight})`;
  ta.value=text.slice(0,s)+rep+text.slice(e);
  ta.selectionStart=s;ta.selectionEnd=s+rep.length;
  ta.dispatchEvent(new Event("input",{bubbles:true}));
}
document.addEventListener("keydown",e=>{
  if(!(e.ctrlKey||e.metaKey))return;
  if(e.key!=="ArrowUp"&&e.key!=="ArrowDown")return;
  const ta=document.activeElement;
  if(!ta||ta.tagName!=="TEXTAREA")return;
  e.preventDefault();
  editAttention(ta,e.key==="ArrowUp"?0.1:-0.1);
});
$("#sd-model").onchange=async()=>{
  $("#model-status").textContent="loading…";
  try{await api("/sdapi/v1/options",{sd_model_checkpoint:$("#sd-model").value});
    $("#model-status").textContent="✓";}
  catch(e){$("#model-status").textContent="✗";toast(e.message,false);}
};

/* ------- image drops ------- */
function wireDrop(el,onImage){
  const read=f=>{const r=new FileReader();r.onload=()=>onImage(r.result);r.readAsDataURL(f);};
  el.addEventListener("dragover",e=>{e.preventDefault();el.classList.add("over");});
  el.addEventListener("dragleave",()=>el.classList.remove("over"));
  el.addEventListener("drop",e=>{e.preventDefault();el.classList.remove("over");
    if(e.dataTransfer.files[0])read(e.dataTransfer.files[0]);});
  el.addEventListener("click",()=>{const i=document.createElement("input");
    i.type="file";i.accept="image/*";i.onchange=()=>i.files[0]&&read(i.files[0]);i.click();});
  document.addEventListener("paste",e=>{
    if(!el.closest(".tab").classList.contains("active"))return;
    for(const it of e.clipboardData.items)if(it.type.startsWith("image")){read(it.getAsFile());break;}
  });
}
const dropData={};
for(const m of ["txt2img","img2img"]){
  wireDrop($(`#${m}-cn-drop`),d=>{dropData[m+"-cn"]=d;
    $(`#${m}-cn-drop`).innerHTML=`<img src="${d}">`;$(`#${m}-cn-enable`).checked=true;});
}
/* img2img init image + mask brush */
let maskOn=false,drawing=false;
wireDrop($("#img2img-drop"),d=>{
  dropData["img2img-init"]=d;
  const box=$("#img2img-drop");box.innerHTML=`<img src="${d}" id="i2i-img"><canvas id="mask-canvas"></canvas>`;
  const img=$("#i2i-img");img.onload=()=>{
    const c=$("#mask-canvas");c.width=img.width;c.height=img.height;
    c.style.width=img.clientWidth+"px";c.style.height=img.clientHeight+"px";
    wireMask(c,img);};
});
function wireMask(c,img){
  const ctx=c.getContext("2d");
  const pos=e=>{const r=c.getBoundingClientRect();
    return [(e.clientX-r.left)*c.width/r.width,(e.clientY-r.top)*c.height/r.height];};
  /* pointer events: stylus/touch with pressure-scaled radius (the
     reference ForgeCanvas's pressure feature, forge_canvas/canvas.py) */
  c.style.touchAction="none";
  c.onpointerdown=e=>{if(!maskOn)return;drawing=true;c.setPointerCapture(e.pointerId);paint(e);};
  c.onpointermove=e=>{if(drawing)paint(e);};
  window.addEventListener("pointerup",()=>drawing=false);
  function paint(e){const [x,y]=pos(e);ctx.fillStyle="rgba(232,131,58,.9)";
    const pr=(e.pointerType!=="mouse"&&e.pressure)?Math.max(e.pressure,0.15):1;
    ctx.beginPath();ctx.arc(x,y,pr*+$("#img2img-brush").value,0,7);ctx.fill();}
}
$("#img2img-mask-toggle").onclick=e=>{maskOn=!maskOn;
  e.target.textContent=maskOn?"Disable mask brush":"Enable mask brush";};
$("#img2img-mask-clear").onclick=()=>{const c=$("#mask-canvas");
  if(c)c.getContext("2d").clearRect(0,0,c.width,c.height);};
function maskB64(){
  const c=$("#mask-canvas");if(!c)return null;
  const ctx=c.getContext("2d");const d=ctx.getImageData(0,0,c.width,c.height);
  let any=false;const out=document.createElement("canvas");
  out.width=c.width;out.height=c.height;const octx=out.getContext("2d");
  const od=octx.createImageData(c.width,c.height);
  for(let i=0;i<d.data.length;i+=4){const a=d.data[i+3];if(a>10)any=true;
    const v=a>10?255:0;od.data[i]=od.data[i+1]=od.data[i+2]=v;od.data[i+3]=255;}
  if(!any)return null;octx.putImageData(od,0,0);return out.toDataURL("image/png");
}

/* ------- generation ------- */
let polling=null;
function startPolling(m){
  const bar=$(`#progress-bar-${m}`);
  polling=setInterval(async()=>{
    try{
      const p=await api("/sdapi/v1/progress");
      bar.style.width=Math.round((p.progress||0)*100)+"%";
      if(p.current_image){
        $(`.pv-${m}`).innerHTML=`<img src="data:image/png;base64,${p.current_image}">`;}
    }catch(e){}
  },700);
}
function stopPolling(m){clearInterval(polling);polling=null;
  $(`#progress-bar-${m}`).style.width="0%";}

function payloadFor(m){
  const v=id=>$(`#${m}-${id}`).value;
  const pl={
    prompt:v("prompt"),negative_prompt:v("negative"),
    sampler_name:v("sampler"),scheduler:v("scheduler"),
    steps:+v("steps"),cfg_scale:+v("cfg"),
    width:+v("width"),height:+v("height"),
    batch_size:+v("batch"),n_iter:+v("niter"),
    seed:+v("seed"),subseed:+v("subseed"),subseed_strength:+v("substrength"),
    clip_skip:+v("clipskip"),
    styles:[...$(`#${m}-styles`).selectedOptions].map(o=>o.value),
  };
  if(m==="txt2img"){
    if($(`#${m}-hr-enable`).checked){
      pl.enable_hr=true;pl.hr_scale=+v("hr-scale");
      pl.hr_upscaler=v("hr-upscaler");pl.hr_second_pass_steps=+v("hr-steps");
      pl.hr_denoising_strength=+v("hr-denoise");
      if(v("hr-model"))pl.hr_checkpoint_name=v("hr-model");
    }
    if(v("refiner")){pl.refiner_checkpoint=v("refiner");pl.refiner_switch_at=+v("refiner-at");}
  }else{
    pl.init_images=[dropData["img2img-init"]?.split(",")[1]].filter(Boolean);
    pl.denoising_strength=+v("denoise");
    pl.inpainting_fill=v("fill");pl.mask_blur=+v("maskblur");
    pl.inpaint_full_res=$(`#${m}-fullres`).checked;
    const mk=maskB64();if(mk)pl.mask=mk.split(",")[1];
  }
  const sname=$(`#${m}-script`)?.value;
  if(sname){
    pl.script_name=sname;
    pl.script_args=[...$$(`#${m}-script-args [data-sarg]`)].map(el=>{
      if(el.type==="checkbox")return el.checked;
      if(el.type==="hidden")return null;
      if(el.type==="number"){const v=+el.value;return Number.isFinite(v)?v:+el.defaultValue||0;}
      if(el.hasAttribute("data-multi"))return [...el.selectedOptions].map(o=>o.value);
      return el.value;});
  }
  const ov={};
  $$(`#${m}-extraopts [data-opt]`).forEach(el=>{
    ov[el.dataset.opt]=el.type==="checkbox"?el.checked:
      (el.type==="number"?+el.value:el.value);});
  if(Object.keys(ov).length)pl.override_settings=ov;
  if($(`#${m}-cn-enable`).checked&&dropData[m+"-cn"]&&v("cn-model")){
    pl.alwayson_scripts={controlnet:{args:[{
      enabled:true,module:v("cn-module"),model:v("cn-model"),
      image:dropData[m+"-cn"].split(",")[1],weight:+v("cn-weight"),
      guidance_start:+v("cn-start"),guidance_end:+v("cn-end")}]}};
  }
  return pl;
}
function showResult(m,res){
  const st=stateImgs[m];
  st.imgs=res.images;const info=JSON.parse(res.info||"{}");
  st.infos=info.infotexts||[];st.lastSeed=info.seed??-1;st.sel=0;
  const gal=$(`#${m}-gallery`);
  gal.innerHTML=st.imgs.map((b,i)=>`<img src="data:image/png;base64,${b}" data-i="${i}" class="${i?'':'sel'}">`).join("");
  $$(`#${m}-gallery img`).forEach(im=>{
    im.onclick=()=>{st.sel=+im.dataset.i;
      $$(`#${m}-gallery img`).forEach(x=>x.classList.remove("sel"));im.classList.add("sel");
      $(`.pv-${m}`).innerHTML=`<img src="data:image/png;base64,${st.imgs[st.sel]}">`;
      $(`.it-${m}`).textContent=st.infos[st.sel]||"";};
    im.ondblclick=()=>{$("#lightbox-img").src=im.src;$("#lightbox").style.display="flex";};
  });
  if(st.imgs[0]){
    $(`.pv-${m}`).innerHTML=`<img src="data:image/png;base64,${st.imgs[0]}">`;
    $(`.it-${m}`).textContent=st.infos[0]||"";
  }
}
for(const m of ["txt2img","img2img"]){
  $(`#${m}-generate`).onclick=async()=>{
    const btn=$(`#${m}-generate`);btn.disabled=true;btn.textContent="Generating…";
    startPolling(m);
    try{
      const res=await api(`/sdapi/v1/${m}`,payloadFor(m));
      showResult(m,res);
    }catch(e){toast(e.message,false);}
    finally{stopPolling(m);btn.disabled=false;btn.textContent="Generate";}
  };
  $(`#${m}-interrupt`).onclick=()=>api("/sdapi/v1/interrupt",{});
  $(`#${m}-style-save`).onclick=async()=>{
    const name=prompt("Style name:");if(!name)return;
    await api("/sdapi/v1/prompt-styles",{name,prompt:$(`#${m}-prompt`).value,
      negative_prompt:$(`#${m}-negative`).value});
    toast("style saved");loadStyles();
  };
  $(`#${m}-skip`).onclick=()=>api("/sdapi/v1/skip",{});
  $(`#${m}-reuse-seed`).onclick=()=>{$(`#${m}-seed`).value=stateImgs[m].lastSeed;};
  $(`#${m}-send-i2i`).onclick=()=>{
    const st=stateImgs[m];if(!st.imgs.length)return;
    dropData["img2img-init"]="data:image/png;base64,"+st.imgs[st.sel];
    $("#img2img-drop").innerHTML=`<img src="${dropData["img2img-init"]}" id="i2i-img">`;
    $("#img2img-prompt").value=$(`#${m}-prompt`).value;
    $$("nav.tabs button")[1].click();
  };
  $(`#${m}-send-extras`).onclick=()=>{
    const st=stateImgs[m];if(!st.imgs.length)return;
    dropData["extras"]="data:image/png;base64,"+st.imgs[st.sel];
    $("#extras-drop").innerHTML=`<img src="${dropData["extras"]}">`;
    $$("nav.tabs button")[2].click();
  };
}
$("#lightbox").onclick=()=>$("#lightbox").style.display="none";

/* ------- extras ------- */
wireDrop($("#extras-drop"),d=>{dropData["extras"]=d;
  $("#extras-drop").innerHTML=`<img src="${d}">`;});
$("#extras-scale").oninput=e=>$("#extras-scale-v").textContent=e.target.value;
$("#extras-run").onclick=async()=>{
  if(!dropData["extras"])return toast("drop an image first",false);
  try{
    const res=await api("/sdapi/v1/extra-single-image",{
      image:dropData["extras"].split(",")[1],
      upscaling_resize:+$("#extras-scale").value,
      upscaler_1:$("#extras-upscaler").value});
    $("#extras-out").innerHTML=`<img src="data:image/png;base64,${res.image}" style="max-width:90%">`;
  }catch(e){toast(e.message,false);}
};

/* ------- png info ------- */
wireDrop($("#pnginfo-drop"),async d=>{
  $("#pnginfo-drop").innerHTML=`<img src="${d}">`;
  try{
    const res=await api("/sdapi/v1/png-info",{image:d.split(",")[1]});
    $("#pnginfo-out").textContent=res.info||"(no parameters found)";
    window._pngparams=res.parameters||null;
  }catch(e){toast(e.message,false);}
});
/* per-field infotext paste bindings (reference infotext_utils.connect_paste:
   every Title-case key the parser emits maps onto its form field) */
function applyInfotext(p,m){
  if(!p)return;
  const set=(id,v)=>{if(v===undefined||v===null)return;const el=$(`#${m}-`+id);
    if(!el)return;
    if(el.type==="checkbox")el.checked=(v===true||v==="True"||v==="true");
    else el.value=v;
    const vv=$(`#${m}-${id}-v`);if(vv)vv.textContent=v;};
  set("prompt",p["Prompt"]);set("negative",p["Negative prompt"]);
  set("steps",p["Steps"]);set("cfg",p["CFG scale"]);set("seed",p["Seed"]);
  set("clipskip",p["Clip skip"]);
  if(p["Size"]){const wh=String(p["Size"]).split("x");set("width",wh[0]);set("height",wh[1]);}
  if(p["Sampler"])$(`#${m}-sampler`).value=p["Sampler"];
  if(p["Schedule type"])$(`#${m}-scheduler`).value=String(p["Schedule type"]).toLowerCase();
  set("subseed",p["Variation seed"]);set("substrength",p["Variation seed strength"]);
  if(m==="img2img"){set("denoise",p["Denoising strength"]);set("maskblur",p["Mask blur"]);}
  if(m==="txt2img"){
    const hr=p["Hires upscale"]||p["Hires upscaler"]||p["Hires steps"];
    set("hr-enable",!!hr);
    set("hr-scale",p["Hires upscale"]);set("hr-steps",p["Hires steps"]);
    if(p["Hires upscaler"])$(`#${m}-hr-upscaler`).value=p["Hires upscaler"];
    if(hr)set("hr-denoise",p["Denoising strength"]);
    if(p["Hires checkpoint"])$(`#${m}-hr-model`).value=p["Hires checkpoint"];
    if(p["Refiner"])$(`#${m}-refiner`).value=p["Refiner"];
    set("refiner-at",p["Refiner switch at"]);
  }
  if(p["Model"]&&confirm("Infotext names checkpoint \""+p["Model"]+"\" — switch to it?"))
    api("/sdapi/v1/options",{sd_model_checkpoint:p["Model"]}).catch(e=>toast(e.message,false));
  fireCounters(m);
}
$("#pnginfo-send").onclick=()=>{
  applyInfotext(window._pngparams,"txt2img");
  $$("nav.tabs button")[0].click();
};
/* toprow paste button: the prompt box holds a raw infotext blob */
["txt2img","img2img"].forEach(m=>{
  $(`#${m}-paste`).onclick=async()=>{
    const raw=$(`#${m}-prompt`).value;
    if(!raw.trim())return toast("prompt box is empty",false);
    try{
      const r=await api("/sdapi/v1/parse-infotext",{text:raw});
      applyInfotext(r.parameters,m);
    }catch(e){toast(e.message,false);}
  };
});

/* token counter + bracket lint (reference modules/ui.py update_token_counter
   + extensions-builtin/prompt-bracket-checker) */
function bracketErrors(s){
  const counts={};(s.match(/[(){}\[\]]/g)||[]).forEach(b=>counts[b]=(counts[b]||0)+1);
  const errs=[];
  [["(",")","round"],["[","]","square"],["{","}","curly"]].forEach(([o,c,kind])=>{
    if((counts[o]||0)!==(counts[c]||0))
      errs.push(`${o}...${c} — ${counts[o]||0} opening vs ${counts[c]||0} closing ${kind} brackets`);
  });
  return errs;
}
const _tokenUpd={};
function wireTokenCounter(m,field,isPositive){
  const ta=$(`#${m}-${field}`),el=$(`#${m}-${field}-count`);
  let h=null,seq=0;
  const upd=async()=>{
    const errs=bracketErrors(ta.value);
    el.title=errs.join("\n");el.classList.toggle("error",errs.length>0);
    const my=++seq;
    try{
      const styles=[...$(`#${m}-styles`).selectedOptions].map(o=>o.value);
      const r=await api("/sdapi/v1/token-count",{text:ta.value,
        steps:+$(`#${m}-steps`).value,styles,is_positive:isPositive});
      if(my===seq)el.textContent=`${r.count}/${r.max}`;
    }catch(e){}
  };
  _tokenUpd[`${m}-${field}`]=upd;
  ta.addEventListener("input",()=>{clearTimeout(h);h=setTimeout(upd,400);});
  upd();
}
function fireCounters(m){
  ["prompt","negative"].forEach(f=>{const u=_tokenUpd[`${m}-${f}`];if(u)u();});
}
["txt2img","img2img"].forEach(m=>{
  wireTokenCounter(m,"prompt",true);
  wireTokenCounter(m,"negative",false);
});

/* ------- spaces ------- */
async function loadSpaces(){
  try{
    const r=await api("/sdapi/v1/spaces");
    const list=r.spaces||[];
    $("#spaces-empty").style.display=list.length?"none":"block";
    $("#spaces-list").innerHTML=list.map(s=>{
      const state=s.running?`running — <a href="${s.url}" target="_blank">${s.url}</a>`
        :(s.installed?"ready":"not installed");
      const btn=s.running?`<button data-space-stop="${s.name}">Terminate</button>`
        :(s.installed?`<button data-space-launch="${s.name}" class="primary">Launch</button>`:"");
      return `<label>${s.title}</label><span class="small">${state} ${btn}</span>`;
    }).join("");
    $$("#spaces-list [data-space-launch]").forEach(b=>b.onclick=async()=>{
      await api("/sdapi/v1/spaces/launch",{name:b.dataset.spaceLaunch});loadSpaces();});
    $$("#spaces-list [data-space-stop]").forEach(b=>b.onclick=async()=>{
      await api("/sdapi/v1/spaces/terminate",{name:b.dataset.spaceStop});loadSpaces();});
  }catch(e){}
}
loadSpaces();

/* ------- extra-networks browser (reference modules/ui_extra_networks*.py:
   kind pages, search, directory chips, cards with previews, user-metadata
   editor persisting to the {path}.json sidecar) ------- */
const netState={kind:"lora",search:"",dir:""};
let lastGenTab="txt2img";
$$("nav.tabs button").forEach(b=>b.addEventListener("click",()=>{
  if(b.dataset.tab==="txt2img"||b.dataset.tab==="img2img")lastGenTab=b.dataset.tab;}));
function netInsert(card){
  if(netState.kind==="checkpoint"){
    api("/sdapi/v1/options",{sd_model_checkpoint:card.name})
      .then(()=>toast("checkpoint set: "+card.name))
      .catch(e=>toast(e.message,false));
    return;
  }
  let ins=card.name;
  if(netState.kind==="lora"){const w=+card.preferred_weight||1;ins=`<lora:${card.name}:${w}>`;}
  else if(netState.kind==="hypernet")ins=`<hypernet:${card.name}:1>`;
  if(card.activation_text)ins+=", "+card.activation_text;
  const t=$(`#${lastGenTab}-prompt`);
  t.value=(t.value?t.value+", ":"")+ins;
  toast("inserted: "+ins);
  $$("nav.tabs button").find(b=>b.dataset.tab===lastGenTab).click();
}
let netEditing=null;
async function netEdit(card){
  let md={};
  try{md=await api(`/sdapi/v1/extra-networks/metadata?kind=${netState.kind}&name=${encodeURIComponent(card.name)}`);}catch(e){}
  netEditing=card.name;
  $("#net-modal-title").textContent=card.name;
  $("#net-md-desc").value=md.description||"";
  $("#net-md-act").value=md["activation text"]||"";
  $("#net-md-weight").value=md["preferred weight"]||0;
  $("#net-md-notes").value=md.notes||"";
  $("#net-modal").style.display="flex";
}
$("#net-md-save").onclick=async()=>{
  try{
    await api("/sdapi/v1/extra-networks/metadata",{name:netEditing,kind:netState.kind,
      description:$("#net-md-desc").value,"activation text":$("#net-md-act").value,
      "preferred weight":+$("#net-md-weight").value,notes:$("#net-md-notes").value});
    toast("metadata saved");$("#net-modal").style.display="none";loadNetCards();
  }catch(e){toast(e.message,false);}
};
$("#net-md-cancel").onclick=()=>$("#net-modal").style.display="none";
async function loadNetCards(){
  let res;
  try{res=await api(`/sdapi/v1/extra-networks/cards?kind=${netState.kind}`+
    `&search=${encodeURIComponent(netState.search)}`);}
  catch(e){toast(e.message,false);return;}
  const dirs=res.dirs||[];
  $("#net-dirs").innerHTML=dirs.length>1?dirs.map(d=>
    `<button data-dir="${d}" class="${netState.dir===d?"active":""}">${d||"."}</button>`).join("")+
    `<button data-dir="" class="${netState.dir===""?"active":""}">all</button>`:"";
  $$("#net-dirs [data-dir]").forEach(b=>b.onclick=()=>{
    netState.dir=b.dataset.dir;loadNetCards();});
  const cards=(res.cards||[]).filter(c=>!netState.dir||c.dir===netState.dir);
  $("#net-empty").style.display=cards.length?"none":"block";
  $("#net-cards").innerHTML=cards.map((c,i)=>{
    const img=c.has_preview?`<img class="thumb" loading="lazy" alt=""
      src="/sdapi/v1/extra-networks/preview?kind=${netState.kind}&name=${encodeURIComponent(c.name)}">`:
      `<div class="thumb ph">&#127924;</div>`;
    return `<div class="card" data-i="${i}">${img}
      <button class="edit" data-e="${i}" title="edit metadata">&#9998;</button>
      <div class="cname">${c.name}</div>
      ${c.description?`<div class="cdesc">${c.description}</div>`:""}</div>`;}).join("");
  $$("#net-cards .card").forEach(el=>el.onclick=e=>{
    if(e.target.classList.contains("edit"))return;
    netInsert(cards[+el.dataset.i]);});
  $$("#net-cards .edit").forEach(el=>el.onclick=e=>{
    e.stopPropagation();netEdit(cards[+el.dataset.e]);});
}
$$("#net-kinds button").forEach(b=>b.onclick=()=>{
  $$("#net-kinds button").forEach(x=>x.classList.remove("active"));
  b.classList.add("active");netState.kind=b.dataset.kind;netState.dir="";loadNetCards();});
$("#net-search").oninput=()=>{clearTimeout(netState._t);
  netState._t=setTimeout(()=>{netState.search=$("#net-search").value;loadNetCards();},250);};
$("#net-refresh").onclick=async()=>{
  try{await api("/sdapi/v1/refresh-loras",{});}catch(e){}
  loadNetCards();};
loadNetCards();

/* ------- xyz grid ------- */
const XYZ_FIELDS=["(none)","seed","steps","cfg_scale","sampler_name","scheduler",
  "denoising_strength","width","height","prompt_sr"];
["xyz-xf","xyz-yf","xyz-zf"].forEach(id=>{
  const el=document.getElementById(id); if(!el)return;
  el.innerHTML=XYZ_FIELDS.map(f=>`<option>${f}</option>`).join("");
});
document.getElementById("xyz-xf").value="seed";
function xyzAxis(fId,vId){
  const f=$("#"+fId).value, raw=$("#"+vId).value.trim();
  if(f==="(none)"||!raw)return null;
  const vals=raw.split(",").map(x=>x.trim()).filter(Boolean)
      .map(x=>isNaN(Number(x))?x:Number(x));
  const a={field:f,values:vals};
  if(f==="prompt_sr")a.search=$("#xyz-sr").value;
  return a;
}
$("#xyz-run").onclick=async()=>{
  $("#xyz-status").textContent="generating…";
  try{
    const body={prompt:$("#xyz-prompt").value,steps:+$("#xyz-steps").value,
      width:+$("#xyz-w").value,height:+$("#xyz-h").value,
      x_axis:xyzAxis("xyz-xf","xyz-xv"),y_axis:xyzAxis("xyz-yf","xyz-yv"),
      z_axis:xyzAxis("xyz-zf","xyz-zv")};
    const r=await api("/sdapi/v1/xyz-grid",body);
    $("#xyz-out").innerHTML=r.images.map(b=>`<img src="data:image/png;base64,${b}">`).join("");
    $("#xyz-status").textContent="done";
  }catch(e){$("#xyz-status").textContent="error: "+e.message;}
};

/* ------- merger ------- */
$("#merge-m").oninput=()=>$("#merge-m-v").textContent=$("#merge-m").value;
async function loadMergeModels(){
  try{
    const models=await api("/sdapi/v1/sd-models");
    const opts='<option value="">(none)</option>'+
      models.map(m=>`<option value="${m.title}">${m.title}</option>`).join("");
    ["merge-a","merge-b","merge-c"].forEach(id=>$("#"+id).innerHTML=opts);
  }catch(e){}
}
loadMergeModels();
$("#merge-run").onclick=async()=>{
  $("#merge-status").textContent="merging…";
  try{
    const r=await api("/sdapi/v1/merge-checkpoints",{
      primary:$("#merge-a").value,secondary:$("#merge-b").value,
      tertiary:$("#merge-c").value||null,
      interp_method:$("#merge-mode").value,
      multiplier:+$("#merge-m").value,custom_name:$("#merge-name").value});
    $("#merge-status").textContent="saved → "+r.path;loadMergeModels();
  }catch(e){$("#merge-status").textContent="error: "+e.message;}
};

/* ------- extensions ------- */
async function loadExtensions(){
  try{
    const ex=await api("/sdapi/v1/extensions");
    $("#ext-table").innerHTML=
      "<tr><th align=left>name</th><th align=left>version</th>"+
      "<th align=left>branch</th><th>enabled</th></tr>"+
      ex.map(e=>`<tr><td>${e.name}</td><td>${e.version||""}</td>
        <td>${e.branch||""}</td><td align=center>${e.enabled?"✓":"—"}</td></tr>`).join("");
    const states=await api("/config_states");
    $("#cfgstate-list").innerHTML=states.map(
      st=>`<div>${st.name} — ${new Date(st.created_at*1000).toLocaleString()}</div>`).join("");
  }catch(e){}
}
loadExtensions();
$("#cfgstate-save").onclick=async()=>{
  await api("/config_states/save",{name:$("#cfgstate-name").value});
  loadExtensions();
};

/* ------- settings ------- */
async function loadSettings(){
  try{
    const o=await api("/sdapi/v1/options");
    $("#settings-grid").innerHTML=Object.entries(o).map(([k,v])=>{
      const t=typeof v==="boolean"?`<input type="checkbox" data-k="${k}" ${v?"checked":""}>`:
        `<input type="text" data-k="${k}" value="${v===null?"":v}">`;
      return `<label>${k}</label>${t}`;}).join("");
  }catch(e){}
}
loadSettings();
$("#settings-save").onclick=async()=>{
  const out={};
  $$("#settings-grid [data-k]").forEach(el=>{
    out[el.dataset.k]=el.type==="checkbox"?el.checked:
      (el.value===""?null:(isNaN(+el.value)||el.value.trim()===""?el.value:+el.value));});
  try{await api("/sdapi/v1/options",out);
    $("#settings-status").textContent="saved ✓";}
  catch(e){$("#settings-status").textContent="✗ "+e.message;}
};
$("#server-stop").onclick=()=>api("/sdapi/v1/server-stop",{}).catch(()=>{});

/* memory footer */
setInterval(async()=>{
  try{const mWrap=await api("/sdapi/v1/memory");
    const dev=(mWrap.tpu||mWrap.cuda||{});const used=dev.used||dev.active&&dev.active.current;
    if(used)$("#mem-status").textContent=`HBM ${(used/2**30).toFixed(1)} GiB`;
  }catch(e){}
},10000);
</script>
</body>
</html>
"""
