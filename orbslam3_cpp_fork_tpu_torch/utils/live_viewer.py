"""Live viewer — the running-system analog of the Pangolin viewer thread.

The reference spawns a Viewer thread (src/System.cc:259-267,
src/Viewer.cc:156) that continuously renders the current frame with
keypoint overlays (FrameDrawer::DrawFrame, src/FrameDrawer.cc:34) and an
interactive 3D map view (MapDrawer, src/MapDrawer.cc:111-427). A
headless TPU deployment has no GL surface, so the live equivalent here
is a background HTTP server on localhost:

- `GET /`           — self-contained page (no external JS): the current
                      annotated frame auto-refreshing, plus a canvas
                      orbit renderer of landmarks / keyframe trajectory
                      polling `/state.json` (drag to orbit, wheel zoom —
                      the MapDrawer camera controls).
- `GET /frame.png`  — latest frame with keypoint overlay (green =
                      tracked landmark, blue = untracked) and a state
                      banner, rendered on demand from the last snapshot.
- `GET /state.json` — landmarks, keyframe trajectory, tracking state,
                      counts; the MapDrawer data feed.

The track thread pushes cheap snapshots (`push_frame`); all rendering
happens lazily on the HTTP thread, so the viewer adds near-zero cost to
the tracking critical path (the reference's FrameDrawer::Update mutex
snapshot has the same shape).
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import viewer as _viewer

log = logging.getLogger("orbslam3_torch.viewer")


def encode_png(img: np.ndarray) -> bytes:
    """8-bit gray or RGB ndarray -> PNG bytes (zlib only)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        color_type = 0
        data = img[:, :, None]
    else:
        color_type = 2
        data = img
    h, w = data.shape[:2]
    raw = b"".join(
        b"\x00" + data[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orbslam3_tpu live</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace;display:flex}
#left{flex:0 0 auto;padding:8px}#right{flex:1 1 auto;position:relative}
canvas{display:block;width:100%;height:100vh}
#hud{position:absolute;top:8px;left:8px}img{max-width:48vw;display:block}</style>
</head><body>
<div id="left"><img id="f" src="/frame.png"><div id="st"></div></div>
<div id="right"><div id="hud"></div><canvas id="c"></canvas></div>
<script>
let DATA={points:[],traj:[],state:"",n_keyframes:0,n_landmarks:0,n_loops:0};
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=0.6,pitch=0.4,czoom=1,ctr=[0,0,0],scale=1;
function resize(){cv.width=cv.clientWidth;cv.height=cv.clientHeight;draw();}
addEventListener('resize',resize);
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.01;
pitch+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw();});
cv.onwheel=e=>{czoom*=Math.exp(-e.deltaY*0.001);draw();e.preventDefault();};
function proj(p){
const cy1=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
let x=p[0]-ctr[0],y=p[1]-ctr[1],z=p[2]-ctr[2];
let x1=cy1*x+sy*z,z1=-sy*x+cy1*z;
let y1=cp*y-sp*z1;
const s=scale*czoom;
return [cv.width/2+x1*s,cv.height/2+y1*s];}
function fit(){const P=DATA.points.concat(DATA.traj);if(!P.length)return;
let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
for(const p of P)for(let i=0;i<3;i++){mn[i]=Math.min(mn[i],p[i]);mx[i]=Math.max(mx[i],p[i]);}
ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
const ext=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-3);
scale=Math.min(cv.width,cv.height)*0.4/ext;}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
ctx.fillStyle='#c8c8c8';
for(const p of DATA.points){const q=proj(p);ctx.fillRect(q[0],q[1],1.5,1.5);}
ctx.strokeStyle='#2f6';ctx.beginPath();
DATA.traj.forEach((p,i)=>{const q=proj(p);i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});
ctx.stroke();
document.getElementById('hud').textContent=
`${DATA.n_landmarks} landmarks | ${DATA.n_keyframes} keyframes | ${DATA.n_loops} loops | ${DATA.state}`;}
async function tick(){
try{const r=await fetch('/state.json');DATA=await r.json();fit();draw();
document.getElementById('st').textContent=
`frame ${DATA.frame_id} | ${DATA.state}`;
document.getElementById('f').src='/frame.png?'+Date.now();}catch(e){}
setTimeout(tick,500);}
resize();tick();
</script></body></html>
"""


class LiveViewer:
    """Background HTTP viewer. `push_frame` from the track thread;
    `state_provider` is a zero-arg callable returning the map snapshot
    dict (called on the HTTP thread — it must take its own locks)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 max_points: int = 20000):
        self._frame_lock = threading.Lock()
        self._frame = None  # (img, xy, valid, tracked, state, frame_id)
        self.state_provider = None
        self.max_points = max_points
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif path == "/frame.png":
                        self._send(200, "image/png", outer._render_frame())
                    elif path == "/state.json":
                        self._send(
                            200, "application/json",
                            json.dumps(outer._state()).encode(),
                        )
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self.server.serve_forever, name="live-viewer", daemon=True
        )
        self._thread.start()
        log.info("live viewer at %s", self.url)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    # -- track-thread side --------------------------------------------

    def push_frame(self, img, xy, valid, tracked, state: str, frame_id: int):
        """Store references only (the arrays are not mutated by the
        tracker after the frame ends) — O(1) on the hot path."""
        with self._frame_lock:
            self._frame = (img, xy, valid, tracked, state, frame_id)

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=5)

    # -- HTTP-thread side ---------------------------------------------

    def _render_frame(self) -> bytes:
        with self._frame_lock:
            snap = self._frame
        if snap is None:
            return encode_png(np.zeros((48, 64), np.uint8))
        img, xy, valid, tracked, state, fid = snap
        rgb = _viewer.draw_frame(img, xy, valid, tracked, state=state)
        return encode_png(rgb)

    def _state(self) -> dict:
        base = {"points": [], "traj": [], "state": "", "frame_id": -1,
                "n_keyframes": 0, "n_landmarks": 0, "n_loops": 0}
        with self._frame_lock:
            if self._frame is not None:
                base["state"] = self._frame[4]
                base["frame_id"] = int(self._frame[5])
        if self.state_provider is not None:
            try:
                snap = self.state_provider()
                pts = np.asarray(snap.get("points", []), np.float32).reshape(-1, 3)
                if len(pts) > self.max_points:
                    pts = pts[:: len(pts) // self.max_points + 1]
                base["points"] = np.round(pts, 4).tolist()
                base["traj"] = (
                    np.round(
                        np.asarray(snap.get("traj", []), np.float32)
                        .reshape(-1, 3), 4
                    ).tolist()
                )
                for k in ("n_keyframes", "n_landmarks", "n_loops"):
                    if k in snap:
                        base[k] = int(snap[k])
            except Exception:
                log.exception("live-viewer state provider failed")
        return base
