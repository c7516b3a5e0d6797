"""HTTP serving layer (counterpart of ``runtime/server.py``): the same
routes and status codes, over the port's pipelines. With a SLAM pipeline
(``--slam``) ``/slam`` serves its snapshot and ``/slam/trajectory`` the
whole trajectory; without one both answer 404 ``{"enabled": false}``.

Route parity with ``cmd/routes.go:25-112`` / ``cmd/handlers``:

  GET  /                      redirect to /live (routes.go:28-31)
  GET  /live                  live view page (live.templ)
  GET  /stream/{left|right|out}   one PNG per request (stream.go:14-37)
  GET  /mjpeg/{left|right|out}    multipart live stream (push upgrade over
                                  the reference's 1 s iframe polling)
  POST /update-params         validated blockSize/maxDisparity retune
                              (params.go:14-69; envelope 3-31 odd,
                              16-256 step 16)
  GET  /params                current parameters as JSON
  POST /{left|right}/configure    attach a TCP camera source
                                  (configure.go:26-120, port/codec form)
  POST /upload                multipart PNG upload -> static source swap,
                              32 MB cap (upload.go:16-97)
  GET  /checkhealth           liveness (routes.go:32)
  GET  /exit                  in-memory log buffer dump (routes.go:38-44)
  GET  /ports                 ingest endpoint discovery (ports.go:14-61
                              equivalent; TCP listeners instead of UART)
  GET  /metrics               pipeline fps/latency + source status (new)
  GET  /slam                  live SLAM snapshot: frames, keyframes, BA runs,
                              loops, backend queue, stage seconds, the newest
                              4096 camera positions (new)
  GET  /slam/trajectory       the whole trajectory in TUM form (index tx ty
                              tz qx qy qz qw, camera to world), or
                              ?format=json for the raw twists (new)

Implemented on stdlib ThreadingHTTPServer: no third-party web framework,
graceful shutdown, streaming-friendly (unbounded write timeouts like
root.go:36's 999 s WriteTimeout).

Hardening beyond the reference (which binds localhost with no auth):
optional bearer-token auth (header or ?token= for <img> tags; only
/checkhealth stays open), TLS via --tls-cert/--tls-key, a cap on
concurrent /mjpeg push streams (503 beyond, count in /metrics), and a
shared per-(slot, seq) PNG encode cache so N viewers cost one encode.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from steroscopic_hardware_tpu_torch.runtime import logger as shlog
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.manager import CameraManager
from steroscopic_hardware_tpu_torch.utils.params import (
    ParamValidationError,
    validate_params,
)
from steroscopic_hardware_tpu_torch.io.png import write_png
from steroscopic_hardware_tpu_torch.ops import se3_np
from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline
from steroscopic_hardware_tpu_torch.runtime.sources import (
    SerialSource,
    StaticSource,
    TcpSource,
    list_serial_ports,
)

MAX_UPLOAD = 32 << 20  # handlers/upload.go:21

# camera slot: left/right, optionally rig-prefixed (rig1.left)
_SLOT_RE = re.compile(r"^(?:([A-Za-z0-9_-]+)\.)?(left|right)$")


def split_slot(slot: str) -> tuple[str, str]:
    """-> (rig, side); raises ParamValidationError on bad names."""
    m = _SLOT_RE.match(slot)
    if not m:
        raise ParamValidationError(
            f"bad camera slot {slot!r} (want left, right, or <rig>.left)"
        )
    return m.group(1) or "", m.group(2)

_LIVE_HTML = """<!doctype html>
<html><head><title>stereo depth — live</title>
<style>
body{font-family:system-ui;margin:2rem;background:#111;color:#eee}
.row{display:flex;gap:1rem;flex-wrap:wrap}
figure{margin:0}figcaption{text-align:center;padding:.3rem;color:#aaa}
img{max-width:30vw;border:1px solid #333;background:#000}
label{display:block;margin-top:.8rem}
#metrics{white-space:pre;font-family:monospace;color:#8c8;margin-top:1rem}
#health.ok{color:#6d6}#health.bad{color:#e66}
#loglines{white-space:pre;font-family:monospace;color:#aa8;
 max-height:14rem;overflow:auto}
.meta{color:#888;font-size:.85rem}
</style></head><body>
<h2>stereo depth — live
 <span class="meta">v{VERSION}</span>
 <span id="health" class="ok">Healthy</span></h2>
<script>
// health poller (1 s), reference app.templ:100-127
setInterval(async()=>{
 const el=document.getElementById('health');
 const t=new Date().toLocaleTimeString();
 try{
  const r=await fetch('/checkhealth'+location.search);
  el.textContent=(r.status==200?'Healthy@':'Unhealthy@')+t;
  el.className=r.status==200?'ok':'bad';
 }catch(e){el.textContent='Unhealthy@'+t;el.className='bad';}
},1000);
</script>
<div class="row">
<figure><img id="left"><figcaption>left</figcaption></figure>
<figure><img id="right"><figcaption>right</figcaption></figure>
<figure><img id="out"><figcaption>depth</figcaption></figure>
<figure id="slamfig" style="display:none">
 <canvas id="slamcv" width="320" height="240"
  style="border:1px solid #333;background:#000"></canvas>
 <figcaption>trajectory <span id="slamstats" class="meta"></span>
 </figcaption>
</figure>
</div>
<script>
// live SLAM trajectory (top-down x/z), drawn from GET /slam
async function drawSlam(){
 try{
  const TOK=new URLSearchParams(location.search).get('token');
  const Q=TOK?'?token='+encodeURIComponent(TOK):'';
  const r=await fetch('/slam'+Q);
  if(r.status!=200)return;
  const d=await r.json();
  if(!d.enabled)return;
  document.getElementById('slamfig').style.display='';
  document.getElementById('slamstats').textContent=
   `${d.positions_total??d.positions.length} poses · `+
   `${d.keyframes} kf · ${d.loops_closed} loops`+
   (d.warm?'':' · warming');
  const cv=document.getElementById('slamcv'),
        g=cv.getContext('2d');
  g.fillStyle='#000';g.fillRect(0,0,cv.width,cv.height);
  const P=d.positions;if(!P||P.length<2)return;
  let xs=P.map(p=>p[0]),zs=P.map(p=>p[2]);
  const x0=Math.min(...xs),x1=Math.max(...xs),
        z0=Math.min(...zs),z1=Math.max(...zs);
  const s=0.9*Math.min(cv.width/Math.max(x1-x0,1e-6),
                       cv.height/Math.max(z1-z0,1e-6));
  const mx=(cv.width-s*(x1-x0))/2,mz=(cv.height-s*(z1-z0))/2;
  g.strokeStyle='#6d6';g.beginPath();
  for(let i=0;i<P.length;i++){
   const x=mx+s*(P[i][0]-x0),y=cv.height-(mz+s*(P[i][2]-z0));
   i?g.lineTo(x,y):g.moveTo(x,y);
  }
  g.stroke();
  const last=P[P.length-1];
  g.fillStyle='#e66';
  g.beginPath();
  g.arc(mx+s*(last[0]-x0),cv.height-(mz+s*(last[2]-z0)),3,0,7);
  g.fill();
 }catch(e){}
}
setInterval(drawSlam,1000);drawSlam();
</script>
<script>
// propagate ?token= into every stream/API URL when auth is enabled
const TOK=new URLSearchParams(location.search).get('token');
const Q=TOK?'?token='+encodeURIComponent(TOK):'';
const api=p=>p+Q;
document.getElementById('left').src=api('/mjpeg/left');
document.getElementById('right').src=api('/mjpeg/right');
document.getElementById('out').src=api('/mjpeg/depth');
</script>
<form id="params">
<label>block size <input type="range" name="blockSize" min="3" max="31"
 step="2" value="7"><span id="bsv">7</span></label>
<label>max disparity <input type="range" name="maxDisparity" min="16"
 max="256" step="16" value="64"><span id="mdv">64</span></label>
</form>
<details><summary>camera setup</summary>
<form id="upload" enctype="multipart/form-data">
 <select name="type"><option>left</option><option>right</option></select>
 <input type="file" name="image" accept="image/png">
 <button type="submit">upload image</button>
</form>
<form id="configure">
 <select name="side"><option>left</option><option>right</option></select>
 host <input name="host" value="127.0.0.1" size="12">
 port <input name="port" size="6">
 codec <select name="codec"><option value="0">raw</option>
  <option value="1">range</option><option value="2">lzma</option></select>
 <button type="submit">connect camera</button>
</form>
<div id="ports" class="meta"></div>
<script>
// ingest endpoint discovery (reference ports.go:14-61 analog)
async function loadPorts(){
 try{const r=await fetch(api('/ports'));const d=await r.json();
  document.getElementById('ports').textContent = d.ports.length
   ? 'discovered: '+d.ports.map(p=>
       (p.kind||'')+' '+p.host+':'+p.port+(p.slot?' ['+p.slot+']':''))
       .join(', ')
   : 'no live ingest endpoints ('+d.hint+')';}catch(e){}}
loadPorts();setInterval(loadPorts,5000);
</script>
</details>
<details id="statuspanel"><summary>status log</summary>
<button id="logrefresh">refresh</button>
<div id="loglines"></div>
<script>
// collapsible status/log panel backed by the ring buffer (/exit),
// reference app.templ:145+
async function loadLog(){
 try{const r=await fetch(api('/exit'));
  document.getElementById('loglines').textContent=await r.text();}
 catch(e){}}
document.getElementById('statuspanel')
 .addEventListener('toggle',e=>{if(e.target.open)loadLog();});
document.getElementById('logrefresh')
 .addEventListener('click',loadLog);
</script>
</details>
<div id="metrics"></div>
<script>
document.getElementById('upload').addEventListener('submit',async e=>{
 e.preventDefault();
 await fetch(api('/upload'),{method:'POST',body:new FormData(e.target)});});
document.getElementById('configure').addEventListener('submit',async e=>{
 e.preventDefault();const f=new FormData(e.target);
 await fetch(api('/'+f.get('side')+'/configure'),{method:'POST',
  body:new URLSearchParams(f)});});
</script>
<script>
const form=document.getElementById('params');let t;
form.addEventListener('input',e=>{
 document.getElementById('bsv').textContent=form.blockSize.value;
 document.getElementById('mdv').textContent=form.maxDisparity.value;
 clearTimeout(t);t=setTimeout(()=>fetch(api('/update-params'),{method:'POST',
  body:new URLSearchParams(new FormData(form))}),300);});
setInterval(async()=>{const r=await fetch(api('/metrics'));
 document.getElementById('metrics').textContent=
  JSON.stringify(await r.json(),null,1);},1000);
</script></body></html>"""


class AppContext:
    """Wires bus + manager + pipeline + config for the handler."""

    def __init__(self, pipeline: DepthPipeline,
                 manager: CameraManager | None = None,
                 auth_token: str | None = None,
                 max_stream_clients: int = 32,
                 rigs: dict[str, DepthPipeline] | None = None,
                 slam_pipeline=None):
        self.manager = manager or CameraManager(pipeline.bus)
        self.bus: FrameBus = self.manager.bus
        self.pipeline = pipeline
        self.slam_pipeline = slam_pipeline  # SlamPipeline or None
        # multi-rig routing: named extra pipelines over prefixed slots
        # (<rig>.left / <rig>.right -> <rig>.out / <rig>.depth); the
        # unnamed default rig is self.pipeline on left/right/out/depth
        self.rigs = dict(rigs or {})
        self.log = shlog.get_logger("server")
        self.started = time.time()
        self.closing = threading.Event()
        # serving hardening: optional bearer token (everything but
        # /checkhealth requires it) and a cap on concurrent push streams
        self.auth_token = auth_token
        self.max_stream_clients = max_stream_clients
        self.stream_clients = 0
        self._stream_lock = threading.Lock()
        # shared PNG encode cache: N mjpeg clients on the same slot cost
        # ONE encode per frame, not N (backpressure fix)
        self._png_cache: dict[str, tuple[int, bytes]] = {}
        self._png_lock = threading.Lock()

    def pipeline_for(self, rig: str) -> DepthPipeline | None:
        """'' or 'default' -> the unnamed rig; else a named rig."""
        if rig in ("", "default"):
            return self.pipeline
        return self.rigs.get(rig)

    def encode_frame(self, name: str, frame) -> bytes:
        """PNG for a bus frame, deduplicated by (slot, seq)."""
        with self._png_lock:
            hit = self._png_cache.get(name)
            if hit is not None and hit[0] == frame.seq:
                return hit[1]
        png = write_png(None, frame.data, compress_level=1)
        with self._png_lock:
            self._png_cache[name] = (frame.seq, png)
        return png


def _make_handler(ctx: AppContext):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            ctx.log.debug(fmt % args)

        # -- helpers --------------------------------------------------------
        def _send(self, code: int, body: bytes,
                  ctype="text/plain; charset=utf-8", extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(),
                       "application/json")

        def _form(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_UPLOAD:
                raise ValueError("body too large")
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                return self._multipart(raw, ctype)
            data = urllib.parse.parse_qs(raw.decode())
            return {k: v[0] for k, v in data.items()}

        def _multipart(self, raw: bytes, ctype: str) -> dict:
            boundary = ctype.split("boundary=")[1].strip().strip('"')
            sep = ("--" + boundary).encode()
            fields = {}
            for part in raw.split(sep):
                part = part.strip(b"\r\n")
                if not part or part == b"--":
                    continue
                if b"\r\n\r\n" not in part:
                    continue
                head, body = part.split(b"\r\n\r\n", 1)
                head = head.decode(errors="replace")
                name = None
                for piece in head.split(";"):
                    piece = piece.strip()
                    if piece.startswith("name="):
                        name = piece[5:].strip('"')
                if name:
                    fields[name] = body
            return fields

        def _authorized(self, path: str) -> bool:
            """Bearer-token check (header or ?token= for <img> tags);
            /checkhealth stays open for liveness probes."""
            if ctx.auth_token is None or path == "/checkhealth":
                return True
            hdr = self.headers.get("Authorization", "")
            if hdr == f"Bearer {ctx.auth_token}":
                return True
            q = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query
            )
            return q.get("token", [None])[0] == ctx.auth_token

        # -- GET ------------------------------------------------------------
        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            try:
                if not self._authorized(path):
                    self._json({"error": "unauthorized"}, code=401)
                    return
                self._do_get(path)
            except (BrokenPipeError, ConnectionResetError):
                pass
            except Exception as e:
                ctx.log.warning("GET handler error on %s: %s", path, e)
                try:
                    self._json({"error": str(e)}, code=500)
                except Exception:
                    pass

        def _is_hx(self) -> bool:
            """htmx-style partial rendering: the reference's
            ``MorphableHandler`` serves the full page or just a fragment
            depending on the ``HX-Request`` header
            (``cmd/handlers/api.go:48-60``); same contract here."""
            return self.headers.get("HX-Request", "").lower() == "true"

        def _metrics_obj(self) -> dict:
            m = {
                "pipeline": ctx.pipeline.metrics(),
                "sources": ctx.manager.status(),
                "stream_clients": ctx.stream_clients,
                "uptime_s": round(time.time() - ctx.started, 1),
            }
            if ctx.rigs:
                m["rigs"] = {name: p.metrics()
                             for name, p in ctx.rigs.items()}
            return m

        def _do_get(self, path):
            if path == "/":
                self._send(302, b"", extra={"Location": "/live"})
            elif path == "/live":
                from steroscopic_hardware_tpu_torch.version import __version__

                if self._is_hx():
                    # fragment: just the status block, for htmx swaps
                    p = ctx.pipeline.metrics()
                    # distinct ID from the /metrics <pre id="metrics">
                    # fragment so a page polling both never holds
                    # duplicate IDs (ADVICE r3)
                    frag = (
                        "<div id=\"live-status\">"
                        f"state {p.get('state', '?')} · frames "
                        f"{p.get('frames', 0)} · fps {p.get('fps', 0)}"
                        "</div>"
                    )
                    self._send(200, frag.encode(),
                               "text/html; charset=utf-8")
                    return
                # build-version display (reference app.templ:92-98 reads
                # debug.ReadBuildInfo; here the package version is
                # stamped server-side)
                page = _LIVE_HTML.replace("{VERSION}", __version__)
                self._send(200, page.encode(),
                           "text/html; charset=utf-8")
            elif path.startswith("/stream/"):
                self._stream_once(path.split("/")[-1])
            elif path.startswith("/mjpeg/"):
                self._stream_live(path.split("/")[-1])
            elif path == "/checkhealth":
                self._send(200, b"OK")
            elif path == "/params":
                self._json(ctx.pipeline.matcher.get_params().to_json())
            elif path == "/metrics":
                m = self._metrics_obj()
                if self._is_hx():
                    # HTML fragment for htmx polling clients; JSON stays
                    # the API representation
                    body = ("<pre id=\"metrics\">"
                            + json.dumps(m, indent=1)
                            + "</pre>").encode()
                    self._send(200, body, "text/html; charset=utf-8")
                else:
                    self._json(m)
            elif path in ("/slam", "/slam/trajectory") and (
                    ctx.slam_pipeline is None):
                self._json({"enabled": False}, code=404)
            elif path == "/slam":
                self._json({"enabled": True,
                            **ctx.slam_pipeline.snapshot()})
            elif path == "/slam/trajectory":
                self._trajectory()
            elif path == "/exit":
                self._send(200, shlog.dump_buffer())
            elif path == "/ports":
                # the reference's real serial-port enumeration
                # (cmd/handlers/ports.go:14-61) plus this runtime's
                # extra ingest surfaces: REAL serial devices first, then
                # live in-process CameraEmitters and the endpoints of
                # every currently configured source.
                from steroscopic_hardware_tpu_torch.runtime.emitter import (
                    list_emitters,
                )
                ports = [{"kind": "serial", "device": d}
                         for d in list_serial_ports()]
                ports += [dict(kind="emitter", **e)
                          for e in list_emitters()]
                with ctx.manager._lock:
                    srcs = dict(ctx.manager._sources)
                for slot, s in srcs.items():
                    if isinstance(s, TcpSource):
                        ports.append({
                            "kind": "configured", "slot": slot,
                            "host": s.host, "port": s.port,
                            "closed": s.closed,
                        })
                    elif isinstance(s, SerialSource):
                        ports.append({
                            "kind": "configured", "slot": slot,
                            "device": s.device, "baud": s.baud,
                            "closed": s.closed,
                        })
                self._json({"ports": ports, "hint":
                            "POST /left/configure host=<h> port=<p> "
                            "(TCP) or device=/dev/ttyUSB0 baud=921600 "
                            "(serial)"})
            else:
                self._send(404, b"not found")

        def _trajectory(self):
            """The whole trajectory, for offline evaluation: TUM form by
            default (index tx ty tz qx qy qz qw per line, camera to
            world), ?format=json for the raw world->camera twists."""
            vo = ctx.slam_pipeline.slam.vo
            with vo.pose_lock:
                xis = (np.stack(vo.trajectory) if vo.trajectory
                       else np.zeros((0, 6), np.float32))
            q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            if q.get("format", ["tum"])[0] == "json":
                self._json({"xi": xis.tolist()})
                return
            pos = se3_np.positions(xis) if len(xis) else xis
            quat = se3_np.quaternions(xis) if len(xis) else xis
            lines = [f"{i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{r[0]:.6f} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f}"
                     for i, (p, r) in enumerate(zip(pos, quat))]
            self._send(200, ("\n".join(lines) + "\n").encode(),
                       "text/plain; charset=utf-8")

        def _stream_once(self, name: str):
            f = ctx.bus.latest(name)
            if f is None:
                self._send(404, f"no frames on {name!r}".encode())
                return
            self._send(200, ctx.encode_frame(name, f), "image/png")

        def _stream_live(self, name: str):
            """multipart/x-mixed-replace push stream of PNG frames.

            Concurrent viewers of the same slot share one PNG encode per
            frame (ctx.encode_frame), and the total number of push
            streams is capped — the overload answer is an immediate 503,
            not a slow stream for everyone."""
            with ctx._stream_lock:
                if ctx.stream_clients >= ctx.max_stream_clients:
                    self._json({"error": "too many stream clients"},
                               code=503)
                    return
                ctx.stream_clients += 1
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "multipart/x-mixed-replace; boundary=frame",
            )
            self.end_headers()
            last = 0
            try:
                while not ctx.closing.is_set():
                    f = ctx.bus.wait_next(name, last, timeout=2.0)
                    if f is None:
                        continue
                    last = f.seq
                    png = ctx.encode_frame(name, f)
                    self.wfile.write(
                        b"--frame\r\nContent-Type: image/png\r\n"
                        + f"Content-Length: {len(png)}\r\n\r\n".encode()
                        + png + b"\r\n"
                    )
            except (BrokenPipeError, ConnectionResetError, OSError):
                return
            finally:
                with ctx._stream_lock:
                    ctx.stream_clients -= 1

        # -- POST -----------------------------------------------------------
        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            try:
                parts = path.strip("/").split("/")
                if not self._authorized(path):
                    self._json({"error": "unauthorized"}, code=401)
                elif path == "/update-params":
                    self._update_params()
                elif len(parts) == 2 and parts[1] == "configure":
                    self._configure(parts[0])
                elif path == "/upload":
                    self._upload()
                else:
                    self._send(404, b"not found")
            except ParamValidationError as e:
                self._json({"error": str(e)}, code=400)
            except ValueError as e:
                if "body too large" in str(e):
                    self._json({"error": str(e)}, code=413)
                else:
                    self._json({"error": str(e)}, code=400)
            except Exception as e:
                ctx.log.warning("handler error on %s: %s", path, e)
                self._json({"error": str(e)}, code=500)

        def _update_params(self):
            form = self._form()
            rig = form.get("rig", "")
            if isinstance(rig, bytes):
                rig = rig.decode()
            pipe = ctx.pipeline_for(rig)
            if pipe is None:
                raise ParamValidationError(f"unknown rig {rig!r}")
            try:
                block = int(form.get("blockSize", 0))
                disp = int(form.get("maxDisparity", 0))
            except (TypeError, ValueError) as e:
                raise ParamValidationError(f"non-integer parameter: {e}")
            params = validate_params(block, disp)
            pipe.matcher.set_params(params)
            ctx.log.info("params updated %s (rig %r)",
                         params.to_json(), rig)
            self._json(params.to_json())

        def _configure(self, slot: str):
            # configure.go:26-120 parity: the reference form carries
            # port + baud rate + compression; here ``device`` (+baud)
            # attaches a REAL serial camera and host+port a TCP one.
            # Slot may be rig-prefixed (rig1.left).
            split_slot(slot)  # validates
            form = self._form()
            codec = int(form.get("codec", 0))
            if codec not in (0, 1, 2):
                raise ParamValidationError(f"bad codec {codec}")
            device = form.get("device", "")
            if isinstance(device, bytes):
                device = device.decode()
            if device:
                baud = int(form.get("baud", 921600))
                if baud <= 0:
                    raise ParamValidationError(f"bad baud {baud}")
                src = SerialSource(ctx.bus, slot, device, baud=baud)
                ctx.manager.set_source(slot, src)
                self._json({"configured": slot, "device": device,
                            "baud": baud, "codec": codec})
                return
            host = form.get("host", "127.0.0.1")
            port = int(form.get("port", 0))
            if isinstance(host, bytes):
                host = host.decode()
            if port <= 0:
                raise ParamValidationError("port or device required")
            src = TcpSource(ctx.bus, slot, host, port)
            ctx.manager.set_source(slot, src)
            self._json({"configured": slot, "host": host, "port": port,
                        "codec": codec})

        def _upload(self):
            form = self._form()
            side = form.get("type", b"left")
            if isinstance(side, bytes):
                side = side.decode()
            split_slot(side)  # validates plain or rig-prefixed slots
            blob = form.get("image")
            if not blob:
                raise ParamValidationError("missing image field")
            from steroscopic_hardware_tpu_torch.io.png import read_png
            from steroscopic_hardware_tpu_torch.ops.gray import to_grayscale

            gray = to_grayscale(read_png(bytes(blob)))
            src = StaticSource(ctx.bus, side, np.asarray(gray))
            ctx.manager.set_source(side, src)
            self._json({"uploaded": side, "shape": list(gray.shape)})

    return Handler


class Server:
    """Lifecycle wrapper: serve_forever on a daemon thread, graceful
    shutdown closing sources and pipeline (cmd/root.go:195-215)."""

    def __init__(self, ctx: AppContext,
                 host="127.0.0.1", port=0,
                 tls_cert: str | None = None, tls_key: str | None = None):
        self.ctx = ctx
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.ctx)
        )
        self.httpd.daemon_threads = True
        if tls_cert is not None:
            import ssl

            sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            sctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = sctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.tls = tls_cert is not None
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        self.ctx.pipeline.start()
        for pipe in self.ctx.rigs.values():
            pipe.start()
        if self.ctx.slam_pipeline is not None:
            self.ctx.slam_pipeline.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        self.ctx.log.info("serving on port %d", self.port)
        return self

    def shutdown(self):
        self.ctx.closing.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.ctx.pipeline.close()
        for pipe in self.ctx.rigs.values():
            pipe.close()
        if self.ctx.slam_pipeline is not None:
            self.ctx.slam_pipeline.close()
        self.ctx.manager.close_all()
