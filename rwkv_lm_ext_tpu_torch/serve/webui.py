"""The browser chat page served at GET /.

A copy of rwkv_lm_ext_tpu/serve/webui.py:14-104 (INDEX_HTML), which holds no
JAX: a zero-dependency page over the same endpoints the API clients use
(/generate with SSE streaming, /process_text for named states, /stats).
"""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>rwkv_lm_ext_tpu_torch</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background: #111;
        color: #ddd; display: flex; flex-direction: column; height: 100vh; }
 #log { flex: 1; overflow-y: auto; padding: 1rem; white-space: pre-wrap; }
 .u { color: #8ec07c; margin: .5em 0 0; }
 .a { color: #ddd; margin: .2em 0 .8em; }
 #bar { display: flex; gap: .5rem; padding: .8rem; background: #1b1b1b; }
 #msg { flex: 1; padding: .5rem; background: #222; color: #eee;
        border: 1px solid #333; border-radius: 4px; }
 button { padding: .5rem 1rem; }
 #opts { display: flex; gap: 1rem; padding: .3rem .8rem; background: #161616;
         font-size: .8rem; align-items: center; flex-wrap: wrap; }
 #opts input, #opts select { width: 5em; background: #222; color: #eee;
         border: 1px solid #333; }
 #stats { margin-left: auto; color: #777; }
</style></head><body>
<div id="log"></div>
<div id="opts">
 <label>max <input id="maxtok" type="number" value="256"></label>
 <label>temp <input id="temp" type="number" step="0.1" value="1.0"></label>
 <label>top_p <input id="topp" type="number" step="0.05" value="0.85"></label>
 <label>action <input id="action" placeholder="(chat)"></label>
 <span id="stats"></span>
</div>
<div id="bar">
 <input id="msg" placeholder="prompt... (Enter to send)" autofocus>
 <button id="send">send</button>
</div>
<script>
const log = document.getElementById('log');
const msg = document.getElementById('msg');
function add(cls, text) {
  const d = document.createElement('div');
  d.className = cls; d.textContent = text; log.appendChild(d);
  log.scrollTop = log.scrollHeight; return d;
}
async function send() {
  const prompt = msg.value.trim();
  if (!prompt) return;
  msg.value = ''; add('u', '> ' + prompt);
  const out = add('a', '');
  const action = document.getElementById('action').value.trim();
  try {
    if (action) {
      const r = await fetch('/process_text', {method: 'POST',
        body: JSON.stringify({text: prompt, action})});
      const j = await r.json();
      out.textContent = j.output ?? j.error ?? JSON.stringify(j);
      return;
    }
    const r = await fetch('/generate', {method: 'POST',
      body: JSON.stringify({
        prompt,
        stream: true,
        max_tokens: +document.getElementById('maxtok').value,
        temperature: +document.getElementById('temp').value,
        top_p: +document.getElementById('topp').value,
      })});
    if (!r.ok) { out.textContent = await r.text(); return; }
    const rd = r.body.getReader(); const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await rd.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n\\n')) >= 0) {
        const line = buf.slice(0, i); buf = buf.slice(i + 2);
        if (!line.startsWith('data: ')) continue;
        const ev = JSON.parse(line.slice(6));
        if (ev.token) out.textContent += ev.token;
        if (ev.error) out.textContent += ' [error: ' + ev.error + ']';
      }
    }
  } catch (e) { out.textContent += ' [' + e + ']'; }
}
document.getElementById('send').onclick = send;
msg.addEventListener('keydown', e => { if (e.key === 'Enter') send(); });
(async () => {
  try {
    const s = await (await fetch('/stats', {method: 'POST',
      body: '{}'})).json();
    const b = s.batcher ? ` · batcher ${s.batcher.n_slots} slots` : '';
    document.getElementById('stats').textContent =
      (s.counts ? '' : '') + 'serving ready' + b;
  } catch (e) {}
})();
</script></body></html>
"""
