// Studio flow state machine (rebuild of Frontend/src — SURVEY.md §2.17):
//   useTranslation.js  — blob-URL lifecycle, AbortController, SSE reader
//   TranslationFlow.js:95-170 — manual `data:` frame parsing from a ReadableStream
//   useAudioRecorder.js — MediaRecorder → decode → OfflineAudioContext 16 kHz
//                         mono render → WAV encode
//   WaveformPlayer.js  — canvas waveform with click-seek + playhead
//   VoiceAnalyticsDashboard.js — stat tiles + pitch/level charts; the reference
//                         renders hard-coded sample data, here the charts are
//                         MEASURED from the translated audio (autocorrelation
//                         pitch track + RMS level track, canvas-drawn)
//   PodcastPage.js     — upload + episode table (episodes kept in localStorage;
//                         the reference keeps them in component state)
//   App.js:355-368     — route shell (studio / analytics / podcasts / pricing)
"use strict";

const LANG_NAMES = {
  eng: "English", fra: "French", deu: "German", spa: "Spanish", ita: "Italian",
  por: "Portuguese", pol: "Polish", tur: "Turkish", rus: "Russian",
  nld: "Dutch", ces: "Czech", arb: "Arabic", cmn: "Chinese", jpn: "Japanese",
  hun: "Hungarian", kor: "Korean", hin: "Hindi", ell: "Greek", ukr: "Ukrainian",
};

const state = {
  mode: "audio", busy: false, abort: null, blobUrl: null,
  recording: null, recordedFile: null, lastAudioBuffer: null,
  sourceBuffer: null,
};
const $ = (id) => document.getElementById(id);

// option label for a backend selector: name + default marker + weight
// provenance tag (a random/fake-weight backend is never silently presented
// as production-ready) + any non-default decode modes (int8 / bucketed ASR
// context / MTP or lossless-spec TTS decode)
function backendOptionLabel(name, b) {
  const w = (b.weights || {})[name];
  const tag = w && w !== "loaded" ? ` \u26a0 ${w} weights` : "";
  const d = (b.decode || {})[name] || {};
  const modes = Object.entries(d)
    .filter(([, v]) => v && v !== "default")
    .map(([stage, v]) => `${stage}:${v}`);
  const dtag = modes.length ? ` [${modes.join(" ")}]` : "";
  return name + (name === b.default ? " (default)" : "") + tag + dtag;
}

// ---- init: populate languages + backends from the API
async function init() {
  try {
    const langs = (await (await fetch("/supported-languages")).json()).languages;
    for (const sel of [$("src"), $("tgt")]) {
      sel.innerHTML = "";
      for (const code of langs) {
        const opt = document.createElement("option");
        opt.value = code;
        opt.textContent = `${LANG_NAMES[code] || code} (${code})`;
        sel.appendChild(opt);
      }
    }
    $("src").value = "eng";
    $("tgt").value = langs.includes("fra") ? "fra" : langs[0];
    const b = await (await fetch("/available-backends")).json();
    $("backend").innerHTML = "";
    for (const name of b.backends) {
      const opt = document.createElement("option");
      opt.value = name;
      opt.textContent = backendOptionLabel(name, b);
      $("backend").appendChild(opt);
    }
  } catch (e) {
    setError(`Could not reach the API: ${e}`);
  }
  renderPodcasts();
}

// ---- OIDC-style auth gate (Frontend/src/index.js:5-21: react-oidc-context
// wired at the app root against a Cognito authority, shipped COMMENTED OUT —
// so this gate is inert until /auth-config reports enabled=true)
const auth = { cfg: null };
const GATED_VIEWS = ["studio", "dub", "podcasts"];

function authSession() {
  try { return JSON.parse(localStorage.getItem("est_auth") || "null"); }
  catch { return null; }
}

function authRequired(view) {
  return !!(auth.cfg && auth.cfg.enabled) && !authSession() &&
         GATED_VIEWS.includes(view);
}

function signinUrl() {
  // authorization-code redirect, the commented cognitoAuthConfig's shape
  // (response_type "code", scope "phone openid email")
  const c = auth.cfg;
  const q = new URLSearchParams({
    client_id: c.client_id,
    redirect_uri: location.origin + location.pathname,
    response_type: c.response_type || "code",
    scope: c.scope || "openid",
  });
  return `${c.authority.replace(/\/$/, "")}/oauth2/authorize?${q.toString()}`;
}

async function initAuth() {
  try { auth.cfg = await (await fetch("/auth-config")).json(); }
  catch { auth.cfg = null; }
  // authorization-code landing: store the session, clean the URL
  const code = new URLSearchParams(location.search).get("code");
  if (code) {
    localStorage.setItem("est_auth", JSON.stringify({ code, ts: Date.now() }));
    history.replaceState(null, "", location.pathname);
  }
  $("login-go").addEventListener("click", () => {
    try { location.assign(signinUrl()); }
    catch (e) { $("login-error").textContent = String(e.message || e); }
  });
}

// ---- top-level views (App.js route shell)
function showView(view) {
  const target = authRequired(view) ? "login" : view;
  for (const b of $("nav").children) {
    b.classList.toggle("active", b.dataset.view === view);
  }
  for (const v of ["home", "studio", "dub", "text", "analytics", "podcasts",
                   "pricing", "login"]) {
    $(`view-${v}`).hidden = v !== target;
  }
}

$("nav").addEventListener("click", (ev) => {
  const btn = ev.target.closest("button[data-view]");
  if (!btn) return;
  showView(btn.dataset.view);
});

// landing CTA → creator studio (App.js Link to="/creator-studio")
$("home-start").addEventListener("click", () => {
  for (const b of $("nav").children) {
    if (b.dataset.view === "studio") b.click();
  }
});

// ---- studio input tabs
$("tabs").addEventListener("click", (ev) => {
  const btn = ev.target.closest("button[data-mode]");
  if (!btn) return;
  state.mode = btn.dataset.mode;
  for (const b of $("tabs").children) b.classList.toggle("active", b === btn);
  $("input-url").hidden = state.mode !== "url";
  $("input-rec").hidden = state.mode !== "record";
  $("input-file").hidden = state.mode === "url" || state.mode === "record";
  // streaming applies only to the audio /translate paths (file or mic) —
  // video and URL flows have their own response shapes
  $("streamrow").hidden = state.mode !== "audio" && state.mode !== "record";
  // lip-sync toggle only makes sense for the video flow
  // (TranslationFlow.js:40,685-693 applyLipSync switch)
  $("lipsyncrow").hidden = state.mode !== "video";
  $("file-label").textContent = {
    audio: "Audio file (.wav / .mp3 / .ogg / .flac)",
    video: "Video file (.mp4 / .mov, ≤150 MB)",
  }[state.mode] || "File";
});

// drag-and-drop upload (TranslateTool.js:72-83 handleDrop/handleDragOver:
// prevent default, accept a type-matched file into the same input pipeline)
$("dropzone").addEventListener("dragover", (e) => {
  e.preventDefault();
  $("dropzone").style.borderColor = "#58a6ff";
});
$("dropzone").addEventListener("dragleave", () => {
  $("dropzone").style.borderColor = "var(--line)";
});
$("dropzone").addEventListener("drop", (e) => {
  e.preventDefault();
  $("dropzone").style.borderColor = "var(--line)";
  const f = e.dataTransfer.files[0];
  if (!f) return;
  // audio mode takes audio/*, video mode video/* (the reference's
  // droppedFile.type.startsWith('audio/') filter)
  const want = state.mode === "video" ? "video/" : "audio/";
  if (f.type && !f.type.startsWith(want)) {
    setError(`Drop a ${want.slice(0, -1)} file here`);
    return;
  }
  const dt = new DataTransfer();
  dt.items.add(f);
  $("file").files = dt.files;
  setError("");
});

function setStatus(msg) { $("status").textContent = msg || ""; }
function setError(msg) { $("error").textContent = msg || ""; }
function setProgress(v) { $("prog").hidden = v == null; if (v != null) $("prog").value = v; }

function freeBlob() {
  if (state.blobUrl) { URL.revokeObjectURL(state.blobUrl); state.blobUrl = null; }
}

function b64ToBlob(b64, type) {
  const bin = atob(b64);
  const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return new Blob([bytes], { type });
}

// ====================== recorder (useAudioRecorder.js) ======================

function encodeWav(samples, rate) {
  const length = samples.length * 2;
  const buffer = new ArrayBuffer(44 + length);
  const view = new DataView(buffer);
  const str = (off, s) => { for (let i = 0; i < s.length; i++) view.setUint8(off + i, s.charCodeAt(i)); };
  str(0, "RIFF"); view.setUint32(4, 36 + length, true); str(8, "WAVE");
  str(12, "fmt "); view.setUint32(16, 16, true); view.setUint16(20, 1, true);
  view.setUint16(22, 1, true); view.setUint32(24, rate, true);
  view.setUint32(28, rate * 2, true); view.setUint16(32, 2, true);
  view.setUint16(34, 16, true); str(36, "data"); view.setUint32(40, length, true);
  let off = 44;
  for (let i = 0; i < samples.length; i++, off += 2) {
    const s = Math.max(-1, Math.min(1, samples[i]));
    view.setInt16(off, s < 0 ? s * 0x8000 : s * 0x7fff, true);
  }
  return new Blob([buffer], { type: "audio/wav" });
}

async function blobToWav16k(blob) {
  // decode → offline render to 16 kHz mono → PCM16 WAV (useAudioRecorder.js:10-65)
  const ctx = new (window.AudioContext || window.webkitAudioContext)();
  const buf = await ctx.decodeAudioData(await blob.arrayBuffer());
  const off = new OfflineAudioContext(1, Math.ceil(buf.duration * 16000), 16000);
  const src = off.createBufferSource();
  src.buffer = buf; src.connect(off.destination); src.start();
  const rendered = await off.startRendering();
  ctx.close();
  return { wav: encodeWav(rendered.getChannelData(0), 16000), buffer: rendered };
}

async function toggleRecording() {
  if (state.recording) {  // stop
    state.recording.recorder.stop();
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({
      audio: { channelCount: 1, echoCancellation: true, noiseSuppression: true },
    });
    const recorder = new MediaRecorder(stream);
    const chunks = [];
    recorder.ondataavailable = (e) => { if (e.data.size) chunks.push(e.data); };
    recorder.onstop = async () => {
      stream.getTracks().forEach((t) => t.stop());
      state.recording = null;
      $("recbtn").classList.remove("recording");
      $("recbtn").textContent = "● Record";
      $("recstate").textContent = "processing…";
      try {
        const { wav, buffer } = await blobToWav16k(new Blob(chunks, { type: recorder.mimeType }));
        state.recordedFile = new File([wav], "recorded-audio.wav", { type: "audio/wav" });
        $("recstate").textContent =
          `recorded ${buffer.duration.toFixed(1)}s — ready to translate`;
        drawWave($("recwave"), buffer.getChannelData(0));
        $("recwave").hidden = false;
      } catch (e) {
        $("recstate").textContent = `recording failed: ${e}`;
      }
    };
    recorder.start(100);
    state.recording = { recorder, stream };
    $("recbtn").classList.add("recording");
    $("recbtn").textContent = "■ Stop";
    $("recstate").textContent = "recording…";
  } catch (e) {
    $("recstate").textContent = `microphone unavailable: ${e}`;
  }
}
$("recbtn").addEventListener("click", toggleRecording);

// =================== waveform player (WaveformPlayer.js) ===================

// wavesurfer zoom + regions parity (WaveformPlayer.js wires wavesurfer.js,
// whose zoom and regions plugins provide these behaviors): wheel-zoom around
// the cursor, drag-to-create a loop region, double-click clears it. `view`
// holds {zoom, offset (left-edge fraction), region: {start, end} fractions}.
const wview = { zoom: 1, offset: 0, region: null, drag: null };

function waveZoomAt(view, cursorFrac, factor) {
  const z = Math.min(64, Math.max(1, view.zoom * factor));
  // keep the sample under the cursor stationary: solve offset from
  // cursorFrac = offset + cursorWindowFrac / zoom for the new zoom
  const within = (cursorFrac - view.offset) * view.zoom; // [0,1] in window
  view.zoom = z;
  view.offset = Math.min(1 - 1 / z, Math.max(0, cursorFrac - within / z));
}

function drawWave(canvas, data, playedFrac = 0, view = null) {
  const { width, height } = canvas.getBoundingClientRect();
  canvas.width = width; canvas.height = height;
  const g = canvas.getContext("2d");
  g.clearRect(0, 0, width, height);
  const zoom = view ? view.zoom : 1;
  const off = view ? view.offset : 0;
  const n = data.length;
  const start = Math.floor(off * n);
  const span = Math.max(1, Math.floor(n / zoom));
  const step = Math.max(1, Math.floor(span / width));
  for (let x = 0; x < width; x++) {
    let min = 1, max = -1;
    const base = start + Math.floor((x / width) * span);
    for (let i = base; i < base + step && i < n; i++) {
      min = Math.min(min, data[i]); max = Math.max(max, data[i]);
    }
    if (min > max) continue;
    const y0 = ((1 + min) / 2) * height, y1 = ((1 + max) / 2) * height;
    const frac = (start + (x / width) * span) / n;
    g.fillStyle = playedFrac > 0 && frac <= playedFrac ? "#3fb950" : "#58a6ff";
    g.fillRect(x, y0, 1, Math.max(1, y1 - y0));
  }
  if (view && view.region) {
    const xa = (view.region.start - off) * zoom * width;
    const xb = (view.region.end - off) * zoom * width;
    g.fillStyle = "rgba(63, 185, 80, 0.22)";
    g.fillRect(xa, 0, Math.max(1, xb - xa), height);
    g.fillStyle = "rgba(63, 185, 80, 0.9)";
    g.fillRect(xa, 0, 1, height); g.fillRect(xb, 0, 1, height);
  }
}

async function showAudioResult(b64, transcripts) {
  freeBlob();
  const blob = b64ToBlob(b64, "audio/wav");
  // Empty-result guard before handing the blob to the player
  // (Frontend/src/utils/audioUtils.js:1-4, useTranslation.js:259-260).
  if (blob.size === 0) throw new Error("Received empty audio data");
  state.blobUrl = URL.createObjectURL(blob);
  $("compare").hidden = true;
  $("player-solo").innerHTML = `<audio controls id="audioel" src="${state.blobUrl}"></audio>`;
  showTranscripts(transcripts);
  $("result").hidden = false;
  try {
    const ctx = new (window.AudioContext || window.webkitAudioContext)();
    const buf = await ctx.decodeAudioData(await blob.arrayBuffer());
    ctx.close();
    state.lastAudioBuffer = buf;
    const data = buf.getChannelData(0);
    const canvas = $("wave");
    canvas.hidden = false;
    wview.zoom = 1; wview.offset = 0; wview.region = null; wview.drag = null;
    const redraw = () =>
      drawWave(canvas, data, $("audioel").currentTime / (buf.duration || 1),
               wview);
    drawWave(canvas, data, 0, wview);
    const audioEl = $("audioel");
    const fracAt = (ev) => {
      const rect = canvas.getBoundingClientRect();
      const x = Math.min(1, Math.max(0, (ev.clientX - rect.left) / rect.width));
      return wview.offset + x / wview.zoom;
    };
    // playhead + region LOOP playback (wavesurfer regions: playback inside a
    // drag-created region loops it)
    audioEl.addEventListener("timeupdate", () => {
      const r = wview.region;
      if (r && buf.duration &&
          audioEl.currentTime / buf.duration > r.end && !audioEl.paused) {
        audioEl.currentTime = r.start * buf.duration;
      }
      redraw();
    });
    // click-seek (WaveformPlayer.js seek semantics), zoom-window-aware;
    // suppressed when the mouseup ends a region drag
    canvas.onclick = (ev) => {
      if (wview.drag && wview.drag.moved) { wview.drag = null; return; }
      wview.drag = null;
      audioEl.currentTime = fracAt(ev) * buf.duration;
    };
    // wheel-zoom around the cursor (wavesurfer zoom plugin)
    canvas.onwheel = (ev) => {
      ev.preventDefault();
      waveZoomAt(wview, fracAt(ev), ev.deltaY < 0 ? 1.3 : 1 / 1.3);
      redraw();
    };
    // drag-to-create region; double-click clears (wavesurfer regions plugin)
    canvas.onmousedown = (ev) => { wview.drag = { a: fracAt(ev), moved: false }; };
    canvas.onmousemove = (ev) => {
      if (!wview.drag) return;
      if (!(ev.buttons & 1)) { wview.drag = null; return; }  // left btn released off-canvas
      const b = fracAt(ev);
      if (Math.abs(b - wview.drag.a) * wview.zoom > 0.004) {
        wview.drag.moved = true;
        wview.region = { start: Math.min(wview.drag.a, b),
                         end: Math.max(wview.drag.a, b) };
        redraw();
      }
    };
    canvas.ondblclick = () => { wview.region = null; redraw(); };
    initTransport(audioEl, buf.duration);
    state.sourceBuffer = await decodeSourceUpload();
    renderAnalytics(buf, state.sourceBuffer);
  } catch { $("wave").hidden = true; $("transport").hidden = true; }
}

// WaveformPlayer.js transport parity: play/pause + rewind + m:ss / m:ss time
// + volume slider with mute toggle (WaveformPlayer.js:17-74).
function fmtTime(t) {
  const m = Math.floor(t / 60), s = Math.floor(t % 60);
  return `${m}:${String(s).padStart(2, "0")}`;
}

function initTransport(audioEl, duration) {
  $("transport").hidden = false;
  // native controls are redundant once the custom transport drives the element
  audioEl.removeAttribute("controls");
  audioEl.volume = parseFloat($("tr-vol").value);
  const setTime = () =>
    $("tr-time").textContent = `${fmtTime(audioEl.currentTime)} / ${fmtTime(duration)}`;
  setTime();
  audioEl.addEventListener("timeupdate", setTime);
  audioEl.addEventListener("play", () => { $("tr-play").textContent = "⏸"; });
  audioEl.addEventListener("pause", () => { $("tr-play").textContent = "▶"; });
  audioEl.addEventListener("ended", () => {
    // finish → reset to the start, like wavesurfer's 'finish' handler
    $("tr-play").textContent = "▶"; audioEl.currentTime = 0;
  });
  $("tr-play").onclick = () =>
    audioEl.paused ? audioEl.play() : audioEl.pause();
  $("tr-rewind").onclick = () => { audioEl.currentTime = 0; };
  $("tr-vol").oninput = (ev) => {
    const v = parseFloat(ev.target.value);
    audioEl.volume = v; audioEl.muted = false;
    $("tr-mute").textContent = v === 0 ? "🔇" : "🔊";
  };
  $("tr-mute").onclick = () => {
    audioEl.muted = !audioEl.muted;
    $("tr-mute").textContent = audioEl.muted ? "🔇" : "🔊";
  };
}

// decode the studio's uploaded/recorded SOURCE audio for the comparative
// analytics pane (the reference dashboard shows source-vs-target series —
// VoiceAnalyticsDashboard.js — but from canned sample data; this measures)
async function decodeSourceUpload() {
  try {
    const f = state.mode === "record" ? state.recordedFile : $("file").files[0];
    if (!f) return null;
    const ctx = new (window.AudioContext || window.webkitAudioContext)();
    const buf = await ctx.decodeAudioData(await f.arrayBuffer());
    ctx.close();
    return buf;
  } catch { return null; }
}

function showVideoResult(b64, transcripts) {
  // side-by-side original / translated (VideoSyncInterface.js layout)
  freeBlob();
  state.blobUrl = URL.createObjectURL(b64ToBlob(b64, "video/mp4"));
  $("player-solo").innerHTML = "";
  const orig = $("file").files[0];
  if (orig) {
    $("compare").hidden = false;
    $("original").innerHTML = `<video controls src="${URL.createObjectURL(orig)}"></video>`;
    $("player").innerHTML = `<video controls src="${state.blobUrl}"></video>`;
  } else {
    $("compare").hidden = true;
    $("player-solo").innerHTML = `<video controls src="${state.blobUrl}"></video>`;
  }
  $("wave").hidden = true;
  showTranscripts(transcripts);
  $("result").hidden = false;
}

// per-phase checklist for the video flow (TranslationFlow.js phase labels)
const VIDEO_PHASES = ["Extracting audio", "Preprocessing audio", "Translating speech",
                      "Adding watermark", "Applying lip sync", "Encoding result"];

function updatePhases(label, progress) {
  if (!label) return;
  const ul = $("phases");
  ul.hidden = false;
  let reached = VIDEO_PHASES.findIndex((p) => label.startsWith(p.split(" ")[0]));
  if (reached < 0) {
    // unknown label (final "complete" frame, lip-sync fallback message):
    // never RESET the checklist — complete marks everything done,
    // anything else keeps the current rendering
    if (progress >= 100 || /complete/i.test(label)) reached = VIDEO_PHASES.length;
    else return;
  }
  ul.innerHTML = VIDEO_PHASES.map((p, i) => {
    const mark = i < reached ? "✓" : i === reached ? "●" : "○";
    const color = i <= reached ? "var(--ok)" : "var(--dim)";
    return `<li style="color:${color}">${mark} ${p}</li>`;
  }).join("");
}

function clearPhases() { $("phases").hidden = true; $("phases").innerHTML = ""; }

function showTranscripts(t) {
  // TranscriptView.js parity: a Show/Hide Transcript toggle revealing
  // language-named sections ("Source Text (English)" / "Target Text
  // (French)") with empty-state fallbacks. Built with createTextNode —
  // transcripts are model output and must not be interpolated into markup.
  const box = $("transcripts");
  box.innerHTML = "";
  if (!t) return;
  const flag = Object.fromEntries(DUB_LANGUAGES.map(([c, , f]) => [c, f]));
  const tgt = $("tgt").value;
  const toggle = document.createElement("button");
  toggle.className = "recbtn";
  toggle.id = "transcript-toggle";
  toggle.textContent = "Show Transcript";
  const panel = document.createElement("div");
  panel.hidden = true;
  toggle.onclick = () => {
    panel.hidden = !panel.hidden;
    toggle.textContent = panel.hidden ? "Show Transcript" : "Hide Transcript";
  };
  const section = (title, text, fallback) => {
    const d = document.createElement("div");
    const b = document.createElement("b");
    b.textContent = title;
    d.appendChild(b);
    d.appendChild(document.createElement("br"));
    d.appendChild(document.createTextNode(text || fallback));
    panel.appendChild(d);
  };
  section(`Source Text (${LANG_NAMES[$("src").value] || $("src").value})`,
          t.source, "No source text available");
  section(`Target Text (${LANG_NAMES[tgt] || tgt}) ${flag[tgt] || ""}`,
          t.target, "No target text available");
  box.appendChild(toggle);
  box.appendChild(panel);
}

// ============== analytics (VoiceAnalyticsDashboard.js, measured) ============

function pitchTrack(data, rate) {
  // per-32ms-frame autocorrelation F0 in 70-350 Hz
  const frame = Math.floor(rate * 0.032), hop = Math.floor(rate * 0.016);
  const lagLo = Math.floor(rate / 350), lagHi = Math.floor(rate / 70);
  const out = [];
  for (let s = 0; s + frame < data.length; s += hop) {
    let energy = 0, energy2 = 0;
    for (let i = 0; i < frame; i++) energy += data[s + i] * data[s + i];
    if (energy / frame < 1e-5) { out.push(NaN); continue; }
    // the lag search strides by 2; the voicing threshold must compare
    // against the SAME stride-2 energy, or the effective normalized-
    // correlation cutoff doubles and moderately voiced frames read as NaN
    for (let i = 0; i < frame; i += 2) energy2 += data[s + i] * data[s + i];
    let bestLag = 0, bestR = 0;
    for (let lag = lagLo; lag <= lagHi; lag++) {
      let r = 0;
      for (let i = 0; i < frame - lag; i += 2) r += data[s + i] * data[s + i + lag];
      if (r > bestR) { bestR = r; bestLag = lag; }
    }
    out.push(bestR > 0.3 * energy2 && bestLag ? rate / bestLag : NaN);
  }
  return out;
}

function levelTrack(data, rate) {
  const hop = Math.floor(rate * 0.032);
  const out = [];
  for (let s = 0; s + hop < data.length; s += hop) {
    let e = 0;
    for (let i = 0; i < hop; i++) e += data[s + i] * data[s + i];
    out.push(20 * Math.log10(Math.sqrt(e / hop) + 1e-9));
  }
  return out;
}

function drawChart(canvas, values, { lo, hi, color = "#58a6ff", unit = "" }) {
  const { width, height } = canvas.getBoundingClientRect();
  canvas.width = width; canvas.height = height;
  const g = canvas.getContext("2d");
  g.clearRect(0, 0, width, height);
  g.strokeStyle = "#30363d";
  g.strokeRect(0.5, 0.5, width - 1, height - 1);
  g.strokeStyle = color; g.lineWidth = 1.5; g.beginPath();
  let pen = false;
  for (let i = 0; i < values.length; i++) {
    const v = values[i];
    if (!isFinite(v)) { pen = false; continue; }
    const x = (i / Math.max(values.length - 1, 1)) * width;
    const y = height - ((v - lo) / (hi - lo)) * height;
    if (pen) g.lineTo(x, y); else { g.moveTo(x, y); pen = true; }
  }
  g.stroke();
  // hover tooltip (recharts <Tooltip/> parity — the reference dashboard's
  // charts show the series value at the cursor): crosshair + value readout,
  // title attribute carries the text for headless assertions
  canvas.onmousemove = (ev) => {
    const rect = canvas.getBoundingClientRect();
    const i = Math.round(((ev.clientX - rect.left) / rect.width) *
                         (values.length - 1));
    const v = values[Math.min(Math.max(i, 0), values.length - 1)];
    drawChart(canvas, values, { lo, hi, color, unit });  // clear old crosshair
    const gg = canvas.getContext("2d");
    const x = (i / Math.max(values.length - 1, 1)) * canvas.width;
    gg.strokeStyle = "#8b949e"; gg.setLineDash([3, 3]);
    gg.beginPath(); gg.moveTo(x, 0); gg.lineTo(x, canvas.height); gg.stroke();
    gg.setLineDash([]);
    const label = isFinite(v) ? `${v.toFixed(1)}${unit}` : "—";
    canvas.title = label;
    gg.fillStyle = "#c9d1d9"; gg.font = "11px sans-serif";
    gg.fillText(label, Math.min(x + 6, canvas.width - 48), 12);
  };
  canvas.onmouseleave = () => {
    canvas.title = "";
    drawChart(canvas, values, { lo, hi, color, unit });
  };
}

// per-clip voice statistics powering the dashboard tiles and radar
// (the reference's stat cards: Average Volume / Speech Rate / Voice
// Clarity / Emotion Match — VoiceAnalyticsDashboard.js:46-51)
function voiceStats(buf) {
  const data = buf.getChannelData(0);
  const rate = buf.sampleRate;
  const pitch = pitchTrack(data, rate);
  const level = levelTrack(data, rate);
  const voiced = pitch.filter(isFinite).sort((a, b) => a - b);
  const active = level.filter((v) => v > -45);
  const mean = (a) => a.reduce((x, y) => x + y, 0) / Math.max(a.length, 1);
  // syllable-nucleus rate from level-peak counting → WPM estimate
  // (≈1.45 syllables per word across the five UI languages)
  let peaks = 0, rising = false;
  const thr = Math.max(...level) - 12;
  for (let i = 1; i < level.length; i++) {
    if (level[i] > thr && level[i] > level[i - 1]) rising = true;
    else if (rising && level[i] < level[i - 1] - 1) { peaks++; rising = false; }
  }
  const sylPerS = peaks / Math.max(buf.duration, 0.1);
  const clarity = voiced.length / Math.max(pitch.length, 1);
  const p = (q) => voiced.length ? voiced[Math.floor(q * (voiced.length - 1))] : NaN;
  return {
    pitch, level,
    levelDb: active.length ? mean(active) : NaN,
    wpm: (sylPerS * 60) / 1.45,
    clarity,
    medianPitch: p(0.5),
    pitchRange: voiced.length >= 4 ? p(0.9) - p(0.1) : 0,
    levelVar: active.length >= 4
      ? Math.sqrt(mean(active.map((v) => (v - mean(active)) ** 2))) : 0,
    duration: buf.duration,
  };
}

function resampleSeries(values, n) {
  const out = [];
  for (let i = 0; i < n; i++) {
    const v = values[Math.floor((i / n) * values.length)];
    out.push(isFinite(v) ? v : NaN);
  }
  return out;
}

// two-series line chart (recharts LineChart parity: source #8b5cf6 vs
// target #ec4899 — VoiceAnalyticsDashboard.js:96-110)
function drawMultiLine(canvas, seriesList, { lo, hi }) {
  const { width, height } = canvas.getBoundingClientRect();
  canvas.width = width; canvas.height = height;
  const g = canvas.getContext("2d");
  g.clearRect(0, 0, width, height);
  g.strokeStyle = "#30363d";
  g.strokeRect(0.5, 0.5, width - 1, height - 1);
  for (const { values, color } of seriesList) {
    g.strokeStyle = color; g.lineWidth = 1.8; g.beginPath();
    let pen = false;
    for (let i = 0; i < values.length; i++) {
      const v = values[i];
      if (!isFinite(v)) { pen = false; continue; }
      const x = (i / Math.max(values.length - 1, 1)) * width;
      const y = height - ((v - lo) / (hi - lo)) * height;
      if (pen) g.lineTo(x, y); else { g.moveTo(x, y); pen = true; }
    }
    g.stroke();
  }
}

// radar chart (recharts RadarChart parity — Volume/Pace/Pitch/Clarity/Emotion
// axes, two translucent polygons — VoiceAnalyticsDashboard.js:117-146)
function drawRadar(canvas, categories, seriesList) {
  const { width, height } = canvas.getBoundingClientRect();
  canvas.width = width; canvas.height = height;
  const g = canvas.getContext("2d");
  g.clearRect(0, 0, width, height);
  const cx = width / 2, cy = height / 2, R = Math.min(cx, cy) - 28;
  const n = categories.length;
  const angle = (i) => -Math.PI / 2 + (2 * Math.PI * i) / n;
  // grid rings + spokes + labels
  g.strokeStyle = "#30363d"; g.fillStyle = "#8b949e"; g.font = "11px sans-serif";
  for (const frac of [0.33, 0.66, 1.0]) {
    g.beginPath();
    for (let i = 0; i <= n; i++) {
      const a = angle(i % n);
      const x = cx + R * frac * Math.cos(a), y = cy + R * frac * Math.sin(a);
      if (i) g.lineTo(x, y); else g.moveTo(x, y);
    }
    g.stroke();
  }
  for (let i = 0; i < n; i++) {
    const a = angle(i);
    g.beginPath(); g.moveTo(cx, cy);
    g.lineTo(cx + R * Math.cos(a), cy + R * Math.sin(a)); g.stroke();
    g.textAlign = Math.cos(a) > 0.3 ? "left" : Math.cos(a) < -0.3 ? "right" : "center";
    g.fillText(categories[i], cx + (R + 12) * Math.cos(a), cy + (R + 12) * Math.sin(a) + 4);
  }
  for (const { values, color } of seriesList) {
    g.beginPath();
    for (let i = 0; i <= n; i++) {
      const a = angle(i % n), v = Math.max(0, Math.min(1, values[i % n]));
      const x = cx + R * v * Math.cos(a), y = cy + R * v * Math.sin(a);
      if (i) g.lineTo(x, y); else g.moveTo(x, y);
    }
    g.strokeStyle = color; g.lineWidth = 2; g.stroke();
    g.fillStyle = color + "40"; g.fill();
  }
}

// grouped bar chart (recharts BarChart parity: emotion distribution —
// VoiceAnalyticsDashboard.js:150-165)
function drawBars(canvas, labels, seriesList) {
  const { width, height } = canvas.getBoundingClientRect();
  canvas.width = width; canvas.height = height;
  const g = canvas.getContext("2d");
  g.clearRect(0, 0, width, height);
  const pad = 18, base = height - 18;
  const group = (width - 2 * pad) / labels.length;
  const barW = Math.min(22, group / (seriesList.length + 1));
  g.fillStyle = "#8b949e"; g.font = "11px sans-serif"; g.textAlign = "center";
  labels.forEach((lab, i) => {
    g.fillText(lab, pad + group * (i + 0.5), height - 4);
    seriesList.forEach(({ values, color }, s) => {
      const h = Math.max(1, values[i] * (base - 10));
      g.fillStyle = color;
      g.fillRect(pad + group * (i + 0.5) + (s - seriesList.length / 2) * barW,
                 base - h, barW - 2, h);
      g.fillStyle = "#8b949e";
    });
  });
}

// deterministic prosody→emotion-profile proxy: the reference's dashboard
// shows an emotion distribution from canned data; here the five bins are
// derived from measured prosody (pitch range / pace / level variance)
function emotionProfile(st) {
  const rangeN = Math.min(st.pitchRange / 150, 1);
  const paceN = Math.min(st.wpm / 220, 1);
  const varN = Math.min(st.levelVar / 12, 1);
  const raw = {
    Neutral: 1.2 - 0.6 * rangeN - 0.4 * varN,
    Happy: 0.4 * rangeN + 0.5 * (st.medianPitch > 180 ? 1 : 0.4),
    Serious: 0.7 - 0.4 * rangeN + 0.3 * (1 - paceN),
    Energetic: 0.5 * paceN + 0.5 * varN,
    Calm: 0.8 - 0.5 * varN - 0.3 * paceN,
  };
  const total = Object.values(raw).reduce((a, b) => a + Math.max(b, 0.01), 0);
  return Object.fromEntries(Object.entries(raw).map(
    ([k, v]) => [k, Math.max(v, 0.01) / total]));
}

function changeChip(target, source, { pct = true, invert = false } = {}) {
  if (!isFinite(target) || !isFinite(source) || source === 0) return "";
  const delta = pct ? ((target - source) / Math.abs(source)) * 100 : target - source;
  const up = (invert ? -delta : delta) >= 0;
  return `<small class="${up ? "up" : "down"}">${delta >= 0 ? "+" : ""}${delta.toFixed(1)}${pct ? "%" : ""} vs source</small>`;
}

function renderAnalytics(buf, srcBuf = null) {
  const st = voiceStats(buf);
  const src = srcBuf ? voiceStats(srcBuf) : null;
  const tiles = [
    ["Average volume", isFinite(st.levelDb) ? `${st.levelDb.toFixed(1)} dB` : "—",
     src ? changeChip(st.levelDb, src.levelDb) : ""],
    ["Speech rate", `${st.wpm.toFixed(0)} WPM`,
     src ? changeChip(st.wpm, src.wpm) : ""],
    ["Voice clarity", `${(st.clarity * 100).toFixed(0)} %`,
     src ? changeChip(st.clarity * 100, src.clarity * 100) : ""],
    ["Median pitch", isFinite(st.medianPitch) ? `${st.medianPitch.toFixed(0)} Hz` : "—",
     src ? changeChip(st.medianPitch, src.medianPitch) : ""],
    ["Duration", `${st.duration.toFixed(1)} s`,
     src ? changeChip(st.duration, src.duration) : ""],
  ];
  $("an-tiles").innerHTML = tiles.map(
    ([t, v, c]) => `<div class="tile"><p>${t}</p><h3>${v}</h3>${c}</div>`).join("");
  $("an-tiles").hidden = false;
  $("an-charts").hidden = false;
  drawChart($("an-pitch"), st.pitch, { lo: 50, hi: 400, unit: " Hz" });
  drawChart($("an-level"), st.level, { lo: -60, hi: 0, color: "#3fb950", unit: " dB" });
  if (src) {
    $("an-note").textContent =
      "Measured from the latest translation — translated output vs your source.";
    $("an-compare").hidden = false;
    const N = 120;
    drawMultiLine($("an-cmp-pitch"), [
      { values: resampleSeries(src.pitch, N), color: "#8b5cf6" },
      { values: resampleSeries(st.pitch, N), color: "#ec4899" },
    ], { lo: 50, hi: 400 });
    const axis = (s) => [
      Math.min(Math.max((s.levelDb + 60) / 60, 0), 1),
      Math.min(s.wpm / 220, 1),
      Math.min((s.medianPitch || 0) / 350, 1),
      s.clarity,
      Math.min(s.pitchRange / 150, 1),
    ];
    drawRadar($("an-radar"), ["Volume", "Pace", "Pitch", "Clarity", "Emotion"], [
      { values: axis(src), color: "#8b5cf6" },
      { values: axis(st), color: "#ec4899" },
    ]);
    const emoS = emotionProfile(src), emoT = emotionProfile(st);
    drawBars($("an-emotion"), Object.keys(emoS), [
      { values: Object.values(emoS), color: "#8b5cf6" },
      { values: Object.values(emoT), color: "#ec4899" },
    ]);
  } else {
    $("an-note").textContent = "Measured from the latest translated audio.";
    $("an-compare").hidden = true;
  }
}

// ====================== podcasts (PodcastPage.js) ===========================

function podcastLog() {
  try { return JSON.parse(localStorage.getItem("podcasts") || "[]"); }
  catch { return []; }
}

function renderPodcasts() {
  const items = podcastLog();
  $("pod-table").hidden = items.length === 0;
  $("pod-rows").innerHTML = items.map((p) =>
    `<tr><td>${p.filename}</td><td>${p.duration_seconds}s</td>
     <td>${p.uploaded}</td><td>${p.podcast_id}</td></tr>`).join("");
}

$("pod-go").addEventListener("click", async () => {
  const f = $("pod-file").files[0];
  if (!f) { $("pod-status").textContent = "Choose a file first"; return; }
  $("pod-status").textContent = "Uploading…";
  try {
    const form = new FormData();
    form.append("file", f);
    const resp = await fetch("/upload_podcast", { method: "POST", body: form });
    const body = await resp.json().catch(() => ({}));
    if (!resp.ok) throw new Error(body.error || `HTTP ${resp.status}`);
    const items = podcastLog();
    items.unshift({ filename: body.filename, duration_seconds: body.duration_seconds,
                    podcast_id: body.podcast_id,
                    uploaded: new Date().toISOString().slice(0, 16).replace("T", " ") });
    localStorage.setItem("podcasts", JSON.stringify(items.slice(0, 50)));
    $("pod-status").textContent = `Uploaded ${body.filename} (${body.duration_seconds}s)`;
    renderPodcasts();
  } catch (e) {
    $("pod-status").textContent = `Upload failed: ${e.message || e}`;
  }
});

// ============================ submission paths ==============================

async function run() {
  // while busy the button stays ENABLED as a Cancel control — disabling it
  // would make the abort branch unreachable
  if (state.busy) { state.abort?.abort(); return; }
  setError(""); setStatus(""); $("result").hidden = true; clearPhases();
  state.busy = true; $("go").textContent = "Cancel";
  state.abort = new AbortController();
  try {
    if (state.mode === "audio" || state.mode === "record") await runAudio();
    else if (state.mode === "video") await runVideo();
    else await runUrl();
  } catch (e) {
    if (e.name !== "AbortError") setError(String(e.message || e));
    else setStatus("Cancelled");
  } finally {
    state.busy = false; $("go").textContent = "Translate"; setProgress(null);
  }
}

function requireFile() {
  if (state.mode === "record") {
    if (!state.recordedFile) throw new Error("Record something first");
    return state.recordedFile;
  }
  const f = $("file").files[0];
  if (!f) throw new Error("Choose a file first");
  if (state.mode === "audio") validateAudioUpload(f);
  return f;
}

// Client-side audio upload validation matching the reference studio flow
// (Frontend/src/hooks/useTranslation.js:111-133, utils/audioUtils.js:35-54):
// extension allow-list, MIME warning (non-fatal), 50 MB cap.
const AUDIO_EXTENSIONS = [".mp3", ".wav", ".ogg", ".m4a"];
const AUDIO_MIME_TYPES = [
  "audio/mp3", "audio/mpeg", "audio/wav", "audio/wave", "audio/x-wav",
  "audio/ogg", "audio/x-m4a", "audio/mp4", "audio/aac",
];
function validateAudioUpload(f) {
  const ext = f.name.toLowerCase().slice(f.name.lastIndexOf("."));
  if (!AUDIO_EXTENSIONS.includes(ext)) {
    throw new Error(`Invalid file extension. Please upload a file with extension: ${AUDIO_EXTENSIONS.join(", ")}`);
  }
  if (!AUDIO_MIME_TYPES.includes(f.type) && f.type !== "") {
    console.warn(`Warning: Unexpected MIME type ${f.type}`);
  }
  if (f.size > 50 * 1024 * 1024) throw new Error("File size exceeds 50MB limit");
}

async function postForm(url, form) {
  const resp = await fetch(url, { method: "POST", body: form, signal: state.abort.signal });
  const body = await resp.json().catch(() => ({}));
  if (!resp.ok) throw new Error(body.error || `HTTP ${resp.status}`);
  return body;
}

// Staged progress messages for the non-SSE audio path, matching the
// reference studio flow (useTranslation.js:26-33 thresholds; simulated
// 2 s interval capped at 90% until the response lands, :202-213).
function progressMessage(p) {
  if (p < 20) return "Preparing your audio for translation...";
  if (p < 40) return "Analyzing speech patterns...";
  if (p < 60) return "Converting to target language...";
  if (p < 80) return "Generating natural speech...";
  if (p < 100) return "Finalizing your translation...";
  return "Translation complete!";
}

function startSimulatedProgress() {
  let p = 10;
  setProgress(p); setStatus(progressMessage(p));
  const iv = setInterval(() => {
    if (p >= 90) { clearInterval(iv); return; }
    p = Math.min(p + Math.random() * 15, 90);
    setProgress(p); setStatus(progressMessage(p));
  }, 2000);
  return () => clearInterval(iv);
}

async function runAudio() {
  if ($("stream-toggle") && $("stream-toggle").checked) return runAudioStreaming();
  const form = new FormData();
  form.append("file", requireFile());
  form.append("source_language", $("src").value);
  form.append("target_language", $("tgt").value);
  form.append("backend", $("backend").value);
  const stopProgress = startSimulatedProgress();
  try {
    const body = await postForm("/translate", form);
    // stop the ticker BEFORE the (async) result render — a pending tick
    // firing during decodeAudioData would roll the status back to an
    // earlier staged message and leave it there
    stopProgress();
    setProgress(100);
    setStatus(`${progressMessage(100)} (request ${body.request_id})`);
    await showAudioResult(body.audio, body.transcripts);
  } finally {
    stopProgress();
  }
}

// Build a base64 WAV from float PCM for the standard result player.
function wavB64FromPcm(f32, rate) {
  const pcm = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++) {
    pcm[i] = Math.max(-32768, Math.min(32767, Math.round(f32[i] * 32767)));
  }
  const header = new ArrayBuffer(44);
  const v = new DataView(header);
  const nBytes = pcm.length * 2;
  const str = (off, s) => { for (let i = 0; i < s.length; i++) v.setUint8(off + i, s.charCodeAt(i)); };
  str(0, "RIFF"); v.setUint32(4, 36 + nBytes, true); str(8, "WAVE");
  str(12, "fmt "); v.setUint32(16, 16, true); v.setUint16(20, 1, true);
  v.setUint16(22, 1, true); v.setUint32(24, rate, true);
  v.setUint32(28, rate * 2, true); v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  str(36, "data"); v.setUint32(40, nBytes, true);
  const bytes = new Uint8Array(44 + nBytes);
  bytes.set(new Uint8Array(header), 0);
  bytes.set(new Uint8Array(pcm.buffer), 44);
  let bin = "";
  for (let i = 0; i < bytes.length; i += 0x8000) {
    bin += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  }
  return btoa(bin);
}

// Streaming studio flow: SSE /translate?stream=1 — transcripts frames carry
// ACCUMULATED text per ASR window (each supersedes the last); PCM16 audio
// chunks are scheduled on a live AudioContext as they arrive, then the full
// take lands in the normal player/waveform.
async function runAudioStreaming() {
  const form = new FormData();
  form.append("file", requireFile());
  form.append("source_language", $("src").value);
  form.append("target_language", $("tgt").value);
  form.append("backend", $("backend").value);
  form.append("stream", "1");
  setProgress(5); setStatus("Streaming translation…");
  const resp = await fetch("/translate", { method: "POST", body: form,
                                           signal: state.abort.signal });
  const ctype = resp.headers.get("content-type") || "";
  if (!resp.ok || !ctype.includes("event-stream")) {
    // server fell back to plain JSON (backend without a streaming path)
    const body = await resp.json().catch(() => ({}));
    if (!resp.ok) throw new Error(body.error || `HTTP ${resp.status}`);
    setProgress(100); setStatus(progressMessage(100));
    return showAudioResult(body.audio, body.transcripts);
  }
  const ctx = new (window.AudioContext || window.webkitAudioContext)();
  let playhead = 0;                 // ctx time the next chunk starts at
  const liveNodes = [];             // scheduled sources, stoppable on cancel
  const pcmParts = [];
  let sampleRate = 16000;
  let lastTranscripts = null;
  let completed = false;
  $("result").hidden = false; $("compare").hidden = true; $("wave").hidden = true;
  $("player-solo").innerHTML = `<div style="color:var(--dim)">● live playback…</div>`;
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  let buffer = "";
  try {
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buffer += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buffer.indexOf("\n\n")) >= 0) {
        const frame = buffer.slice(0, idx); buffer = buffer.slice(idx + 2);
        if (!frame.startsWith("data: ")) continue;
        const msg = JSON.parse(frame.slice(6));
        if (msg.error) throw new Error(`${msg.error} (${msg.error_id || "?"})`);
        if (msg.progress) setProgress(msg.progress);
        if (msg.phase) setStatus(msg.phase);
        if (msg.transcripts) { lastTranscripts = msg.transcripts; showTranscripts(msg.transcripts); }
        if (msg.audio_chunk) {
          sampleRate = msg.sample_rate || 16000;
          const bytes = Uint8Array.from(atob(msg.audio_chunk), (c) => c.charCodeAt(0));
          const i16 = new Int16Array(bytes.buffer, 0, bytes.byteLength >> 1);
          const f32 = Float32Array.from(i16, (s) => s / 32768);
          pcmParts.push(f32);
          const abuf = ctx.createBuffer(1, f32.length, sampleRate);
          abuf.copyToChannel(f32, 0);
          const node = ctx.createBufferSource();
          node.buffer = abuf; node.connect(ctx.destination);
          playhead = Math.max(playhead, ctx.currentTime + 0.05);
          node.start(playhead);
          playhead += abuf.duration;
          liveNodes.push(node);
        }
      }
    }
    completed = true;
  } finally {
    if (completed) {
      // success: let the scheduled tail finish before the context closes
      const tail = Math.max(0, (playhead - ctx.currentTime) * 1000) + 200;
      setTimeout(() => ctx.close().catch(() => {}), tail);
    } else {
      // cancel / mid-stream error: silence immediately — nothing buffered
      // should keep playing after the UI says Cancelled/Error
      for (const n of liveNodes) { try { n.stop(); } catch {} }
      ctx.close().catch(() => {});
    }
  }
  const total = pcmParts.reduce((n, p) => n + p.length, 0);
  if (!total) {
    // "silence in, structured empty out": the server's contract for
    // no-speech input is a successful stream with transcripts and zero
    // audio chunks — render that as a result, not an error
    setProgress(100); setStatus("No speech detected in the input");
    $("player-solo").innerHTML = "";
    showTranscripts(lastTranscripts);
    return;
  }
  const all = new Float32Array(total);
  let off = 0;
  for (const p of pcmParts) { all.set(p, off); off += p.length; }
  setProgress(100); setStatus(progressMessage(100));
  await showAudioResult(wavB64FromPcm(all, sampleRate), lastTranscripts);
}

async function runVideo() {
  const form = new FormData();
  form.append("file", requireFile());
  form.append("source_language", $("src").value);
  form.append("target_language", $("tgt").value);
  // lip-sync toggle (TranslationFlow.js:91 posts the same form flag)
  form.append("apply_lip_sync", $("lipsync-toggle").checked ? "true" : "false");
  setProgress(0);
  const resp = await fetch("/process-video", { method: "POST", body: form,
                                               signal: state.abort.signal });
  if (!resp.ok) {
    const body = await resp.json().catch(() => ({}));
    throw new Error(body.error || `HTTP ${resp.status}`);
  }
  // manual SSE parse from the ReadableStream (TranslationFlow.js:95-170)
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  let buffer = "";
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    buffer += decoder.decode(value, { stream: true });
    let idx;
    while ((idx = buffer.indexOf("\n\n")) >= 0) {
      const frame = buffer.slice(0, idx); buffer = buffer.slice(idx + 2);
      if (!frame.startsWith("data: ")) continue;
      const msg = JSON.parse(frame.slice(6));
      setProgress(msg.progress); setStatus(msg.phase || "");
      updatePhases(msg.phase, msg.progress);
      if (msg.error) throw new Error(`${msg.error} (${msg.error_id || "?"})`);
      if (msg.result) showVideoResult(msg.result.video, msg.result.transcripts);
    }
  }
}

async function runUrl() {
  const url = $("url").value.trim();
  if (!url) throw new Error("Enter a URL first");
  // Client-side Spotify guidance before the request, matching the reference's
  // LinkSection (Frontend/src/components/ui/LinkSection.js:22-28,61-67).
  if (url.includes("spotify.com")) {
    throw new Error("Spotify tracks aren't currently supported. Try YouTube or TikTok instead!");
  }
  setStatus("Fetching and translating…");
  const resp = await fetch("/process-audio-url", {
    method: "POST", headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ url, target_language: $("tgt").value }),
    signal: state.abort.signal,
  });
  const body = await resp.json().catch(() => ({}));
  if (!resp.ok) throw new Error(body.error || `HTTP ${resp.status}`);
  setStatus("Done");
  await showAudioResult(body.audio, body.transcripts);
}

$("go").addEventListener("click", run);

// ====================== Video Dubbing (VideoSyncInterface.js:10-91 parity) ==
// Standalone dubbing view: 36-language flag picker (common-first ordering),
// 50 MB cap, voice-cloning toggle, manual SSE progress, result video +
// download.

const DUB_LANGUAGES = [
  // most common first (VideoSyncInterface.js SUPPORTED_LANGUAGES order)
  ["fra", "French", "🇫🇷"], ["spa", "Spanish", "🇪🇸"], ["deu", "German", "🇩🇪"],
  ["ita", "Italian", "🇮🇹"], ["por", "Portuguese", "🇵🇹"], ["rus", "Russian", "🇷🇺"],
  ["jpn", "Japanese", "🇯🇵"], ["cmn", "Chinese (Simplified)", "🇨🇳"],
  ["ukr", "Ukrainian", "🇺🇦"],
  // rest alphabetical
  ["ben", "Bengali", "🇧🇩"], ["cat", "Catalan", "🏴󠁥󠁳󠁣󠁴󠁿"],
  ["cmn_Hant", "Chinese (Traditional)", "🇹🇼"], ["cym", "Welsh", "🏴󠁧󠁢󠁷󠁬󠁳󠁿"],
  ["dan", "Danish", "🇩🇰"], ["eng", "English", "🇬🇧"], ["est", "Estonian", "🇪🇪"],
  ["fin", "Finnish", "🇫🇮"], ["hin", "Hindi", "🇮🇳"], ["ind", "Indonesian", "🇮🇩"],
  ["kor", "Korean", "🇰🇷"], ["mlt", "Maltese", "🇲🇹"], ["nld", "Dutch", "🇳🇱"],
  ["pes", "Persian", "🇮🇷"], ["pol", "Polish", "🇵🇱"], ["ron", "Romanian", "🇷🇴"],
  ["slk", "Slovak", "🇸🇰"], ["swe", "Swedish", "🇸🇪"], ["swh", "Swahili", "🇹🇿"],
  ["tel", "Telugu", "🇮🇳"], ["tgl", "Tagalog", "🇵🇭"], ["tha", "Thai", "🇹🇭"],
  ["tur", "Turkish", "🇹🇷"], ["urd", "Urdu", "🇵🇰"], ["uzn", "Uzbek", "🇺🇿"],
  ["vie", "Vietnamese", "🇻🇳"],
];
const dub = { file: null, lang: "fra", blobUrl: null };

function initDub() {
  const grid = $("dub-langs");
  grid.innerHTML = "";
  for (const [code, name, flag] of DUB_LANGUAGES) {
    const b = document.createElement("button");
    b.dataset.code = code;
    b.textContent = `${flag} ${name}`;
    b.classList.toggle("active", code === dub.lang);
    grid.appendChild(b);
  }
  grid.addEventListener("click", (ev) => {
    const b = ev.target.closest("button[data-code]");
    if (!b) return;
    dub.lang = b.dataset.code;
    for (const x of grid.children) x.classList.toggle("active", x === b);
  });
  // backend selector for this view too (BackendSelector.js:13)
  fetch("/available-backends").then((r) => r.json()).then((b) => {
    $("dub-backend").innerHTML = "";
    for (const name of b.backends) {
      const opt = document.createElement("option");
      opt.value = name;
      opt.textContent = backendOptionLabel(name, b);
      $("dub-backend").appendChild(opt);
    }
  }).catch(() => {});
}

$("dub-file").addEventListener("change", () => {
  const f = $("dub-file").files[0];
  $("dub-error").textContent = "";
  const reject = (msg) => {
    // clear the stale selection too — otherwise a previously valid video
    // would be silently submitted while the input shows the rejected one
    $("dub-error").textContent = msg;
    dub.file = null;
    $("dub-file").value = "";
    $("dub-preview").hidden = true;
  };
  if (!f) return;
  if (!f.type.startsWith("video/")) {
    reject("Please upload a valid video file");
    return;
  }
  if (f.size > 50 * 1024 * 1024) {  // VideoSyncInterface.js 50 MB cap
    reject("Video file size should be less than 50MB");
    return;
  }
  dub.file = f;
  if (dub.blobUrl) URL.revokeObjectURL(dub.blobUrl);
  dub.blobUrl = URL.createObjectURL(f);
  $("dub-preview").src = dub.blobUrl;
  $("dub-preview").hidden = false;
});

$("dub-go").addEventListener("click", async () => {
  $("dub-error").textContent = "";
  if (!dub.file) { $("dub-error").textContent = "Choose a video first"; return; }
  const form = new FormData();
  form.append("file", dub.file);
  form.append("target_language", dub.lang);
  form.append("backend", $("dub-backend").value || "cascaded");
  form.append("use_voice_cloning", $("dub-clone").checked ? "true" : "false");
  form.append("apply_lip_sync", $("dub-lipsync").checked ? "true" : "false");
  $("dub-go").disabled = true;
  $("dub-prog").hidden = false; $("dub-prog").value = 0;
  $("dub-result").hidden = true;
  try {
    const resp = await fetch("/process-video", { method: "POST", body: form });
    if (!resp.ok) {
      const body = await resp.json().catch(() => ({}));
      throw new Error(body.error || `HTTP ${resp.status}`);
    }
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buffer = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buffer += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buffer.indexOf("\n\n")) >= 0) {
        const frame = buffer.slice(0, idx); buffer = buffer.slice(idx + 2);
        if (!frame.startsWith("data: ")) continue;
        const msg = JSON.parse(frame.slice(6));
        if (msg.error) throw new Error(`${msg.error} (${msg.error_id || "?"})`);
        if (msg.progress !== undefined) {
          $("dub-prog").value = msg.progress;
          $("dub-phase").textContent = msg.phase || "";
        }
        if (msg.result) {
          const blob = b64ToBlob(msg.result.video, "video/mp4");
          const url = URL.createObjectURL(blob);
          $("dub-out").src = url;
          $("dub-download").href = url;
          const t = msg.result.transcripts || {};
          $("dub-transcripts").innerHTML = "";
          for (const k of ["source", "target"]) {
            if (!t[k]) continue;
            const d = document.createElement("div");
            const b = document.createElement("b");
            b.textContent = k + ": ";
            d.appendChild(b);
            d.appendChild(document.createTextNode(t[k]));
            $("dub-transcripts").appendChild(d);
          }
          $("dub-result").hidden = false;
        }
      }
    }
    $("dub-phase").textContent = "Done";
  } catch (e) {
    $("dub-error").textContent = String(e.message || e);
  } finally {
    $("dub-go").disabled = false;
  }
});

// =================== Translate Text (TranslateTool text mode) ==============

function initTextTool() {
  fetch("/supported-languages").then((r) => r.json()).then(({ languages }) => {
    for (const sel of [$("tt-src"), $("tt-tgt")]) {
      sel.innerHTML = "";
      for (const code of languages) {
        const opt = document.createElement("option");
        opt.value = code;
        opt.textContent = `${LANG_NAMES[code] || code} (${code})`;
        sel.appendChild(opt);
      }
    }
    $("tt-src").value = "eng";
    $("tt-tgt").value = languages.includes("fra") ? "fra" : languages[0];
  }).catch(() => {});
}

$("tt-go").addEventListener("click", async () => {
  $("tt-error").textContent = "";
  const text = $("tt-text").value.trim();
  if (!text) { $("tt-error").textContent = "Type some text first"; return; }
  $("tt-go").disabled = true;
  try {
    const resp = await fetch("/translate-text", {
      method: "POST", headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        text,
        source_language: $("tt-src").value,
        target_language: $("tt-tgt").value,
        synthesize: $("tt-speak").checked,
      }),
    });
    const body = await resp.json().catch(() => ({}));
    if (!resp.ok) throw new Error(body.error || `HTTP ${resp.status}`);
    $("tt-out").innerHTML = "";
    for (const [label, value] of [["source", body.source_text],
                                  ["target", body.target_text]]) {
      const d = document.createElement("div");
      const b = document.createElement("b");
      b.textContent = label + ": ";
      d.appendChild(b);
      d.appendChild(document.createTextNode(value || ""));
      $("tt-out").appendChild(d);
    }
    $("tt-player").innerHTML = "";
    if (body.audio) {
      const audio = document.createElement("audio");
      audio.controls = true;
      audio.src = URL.createObjectURL(b64ToBlob(body.audio, "audio/wav"));
      $("tt-player").appendChild(audio);
    }
    $("tt-result").hidden = false;
  } catch (e) {
    $("tt-error").textContent = String(e.message || e);
  } finally {
    $("tt-go").disabled = false;
  }
});

initDub();
initTextTool();
initAuth().then(init);
