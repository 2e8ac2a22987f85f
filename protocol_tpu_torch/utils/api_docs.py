"""Self-contained interactive API docs page
(``protocol_tpu/utils/api_docs.py``, copied).

The reference serves Swagger UI for its orchestrator API
(crates/orchestrator/src/api/server.rs:46-97, utoipa-swagger-ui). That
ships a bundled third-party JS app; this framework's deployments are
zero-egress and dependency-light, so /docs is a single static page —
no CDN, no vendored bundle — that fetches the service's own
/openapi.json and renders an explorer with a try-it console
(method + path + bearer key + JSON body -> live response).
"""

from __future__ import annotations

DOCS_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>protocol_tpu API</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 14px/1.5 system-ui, sans-serif; margin: 0 auto; max-width: 960px;
         padding: 1.5rem; }
  h1 { font-size: 1.3rem; }
  .op { border: 1px solid color-mix(in srgb, currentColor 25%, transparent);
        border-radius: 6px; margin: .4rem 0; }
  .op > summary { padding: .45rem .7rem; cursor: pointer; display: flex;
                  gap: .7rem; align-items: baseline; }
  .op[open] > summary { border-bottom: 1px solid
                        color-mix(in srgb, currentColor 15%, transparent); }
  .m { font-weight: 700; width: 4.2em; text-align: center; border-radius: 4px;
       padding: .05rem .3rem; font-size: .8rem; color: #fff; }
  .get { background: #2f7d4f; } .post { background: #2b6cb0; }
  .put { background: #b7791f; } .delete { background: #c53030; }
  .path { font-family: ui-monospace, monospace; }
  .sum { opacity: .75; flex: 1; text-align: right; font-size: .85rem; }
  .body { padding: .7rem; }
  textarea, input { font: 12px ui-monospace, monospace; width: 100%;
                    box-sizing: border-box; margin: .15rem 0; }
  textarea { min-height: 4.5rem; }
  pre { background: color-mix(in srgb, currentColor 8%, transparent);
        padding: .6rem; border-radius: 6px; overflow: auto; max-height: 22rem; }
  button { cursor: pointer; padding: .25rem .9rem; }
  #key { max-width: 22rem; }
  .muted { opacity: .65; }
</style>
</head>
<body>
<h1 id="title">protocol_tpu API</h1>
<p class="muted" id="desc"></p>
<p><label>Authorization bearer key (admin routes):
   <input id="key" placeholder="admin" autocomplete="off"></label></p>
<div id="ops">loading /openapi.json…</div>
<script>
(async () => {
  const spec = await (await fetch('openapi.json')).json();
  document.getElementById('title').textContent =
    spec.info.title + ' — v' + spec.info.version;
  document.getElementById('desc').textContent = spec.info.description || '';
  const ops = document.getElementById('ops');
  ops.textContent = '';
  // escape spec-derived strings: a route docstring (or parameter name)
  // containing HTML must render as text, not inject into the page
  const esc = (s) => String(s).replace(/[&<>"']/g, (c) => ({
    '&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;', "'": '&#39;',
  }[c]));
  for (const [path, methods] of Object.entries(spec.paths)) {
    for (const [method, op] of Object.entries(methods)) {
      const d = document.createElement('details');
      d.className = 'op';
      const params = (op.parameters || []).map(p => p.name);
      const mcls = /^[a-z]+$/.test(method) ? method : 'get';
      d.innerHTML = `
        <summary>
          <span class="m ${mcls}">${esc(method.toUpperCase())}</span>
          <span class="path">${esc(path)}</span>
          <span class="sum">${esc(op.summary || '')}</span>
        </summary>
        <div class="body">
          ${params.map(p =>
            `<label>${esc(p)}: <input data-param="${esc(p)}"></label>`).join('')}
          ${['post', 'put', 'patch'].includes(method)
            ? '<textarea data-body placeholder="JSON body"></textarea>' : ''}
          <button data-send>Send</button>
          <pre data-out class="muted">—</pre>
        </div>`;
      d.querySelector('[data-send]').onclick = async () => {
        let url = path;
        for (const inp of d.querySelectorAll('[data-param]'))
          url = url.replace('{' + inp.dataset.param + '}',
                            encodeURIComponent(inp.value));
        const headers = {};
        const key = document.getElementById('key').value;
        if (key) headers['Authorization'] = 'Bearer ' + key;
        const bodyEl = d.querySelector('[data-body]');
        const init = { method: method.toUpperCase(), headers };
        if (bodyEl && bodyEl.value) {
          headers['Content-Type'] = 'application/json';
          init.body = bodyEl.value;
        }
        const out = d.querySelector('[data-out]');
        out.textContent = '…';
        try {
          const r = await fetch(url, init);
          const text = await r.text();
          let shown = text;
          try { shown = JSON.stringify(JSON.parse(text), null, 2); }
          catch (e) {}
          out.textContent = r.status + ' ' + r.statusText + '\\n' + shown;
        } catch (e) { out.textContent = 'request failed: ' + e; }
      };
      ops.appendChild(d);
    }
  }
})();
</script>
</body>
</html>
"""


def docs_handler():
    """aiohttp handler serving the docs page (mount next to /openapi.json)."""
    from aiohttp import web

    async def handler(request: web.Request) -> web.Response:
        return web.Response(text=DOCS_HTML, content_type="text/html")

    return handler
