"""Offline visualization — the TPU build's viewer stack.

The reference renders live with Pangolin/OpenGL on a dedicated thread
(Viewer src/Viewer.cc:156, FrameDrawer src/FrameDrawer.cc:34, MapDrawer
src/MapDrawer.cc:111). A headless accelerator deployment has no GL
surface, so the equivalents here are offline exporters fed by the same
state snapshots:

- `draw_frame`     — FrameDrawer::DrawFrame: current image + keypoint
                     overlay (green = tracked landmark, blue = new) and
                     a state banner, as an RGB uint8 array (save with
                     `save_png`).
- `export_map_ply` — MapDrawer: landmarks + keyframe frusta as a PLY
                     point/edge cloud any viewer (MeshLab, CloudCompare,
                     rerun) can open.
- `export_map_html`— self-contained interactive HTML (canvas orbit
                     renderer, no external JS) of the map + trajectory.
- `Viewer`         — periodic snapshot writer wired to a System, the
                     offline analog of the viewer thread.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

# Keypoint overlay colors (RGB), reference FrameDrawer draws tracked
# map points green and newly created ones blue.
_GREEN = np.array([0, 220, 40], np.uint8)
_BLUE = np.array([60, 120, 255], np.uint8)
_RED = np.array([230, 50, 50], np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer (8-bit gray or RGB) using zlib only."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        color_type, channels = 0, 1
        data = img[:, :, None]
    else:
        color_type, channels = 2, 3
        data = img
    h, w = data.shape[:2]
    raw = b"".join(
        b"\x00" + data[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def _draw_square(rgb: np.ndarray, x: int, y: int, color: np.ndarray, r: int = 3):
    h, w = rgb.shape[:2]
    x0, x1 = max(0, x - r), min(w, x + r + 1)
    y0, y1 = max(0, y - r), min(h, y + r + 1)
    if x1 <= x0 or y1 <= y0:
        return
    rgb[y0, x0:x1] = color
    rgb[y1 - 1, x0:x1] = color
    rgb[y0:y1, x0] = color
    rgb[y0:y1, x1 - 1] = color


def draw_frame(
    img: np.ndarray,
    xy: np.ndarray,
    valid: np.ndarray,
    tracked: np.ndarray | None = None,
    state: str = "",
) -> np.ndarray:
    """FrameDrawer::DrawFrame analog: gray image + keypoint boxes.

    img (H,W) float/uint8 gray; xy (N,2); valid (N,) bool; tracked (N,)
    bool marks keypoints bound to map landmarks (drawn green, others
    blue). Returns (H+18, W, 3) uint8 with a status banner row.
    """
    g = np.clip(np.asarray(img, np.float32), 0, 255).astype(np.uint8)
    rgb = np.repeat(g[:, :, None], 3, axis=2)
    h, w = g.shape
    if tracked is None:
        tracked = np.zeros(len(xy), bool)
    for i in range(len(xy)):
        if not valid[i]:
            continue
        x, y = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
        if 0 <= x < w and 0 <= y < h:
            _draw_square(rgb, x, y, _GREEN if tracked[i] else _BLUE)
    banner = np.zeros((18, w, 3), np.uint8)
    banner[:, :] = (30, 30, 30)
    out = np.concatenate([rgb, banner], axis=0)
    _stamp_text(out, state, 4, h + 4)
    return out


def _stamp_text(rgb: np.ndarray, text: str, x: int, y: int):
    """Status banner marks: each character renders as a 4-px-wide column
    pattern keyed by its code (a full bitmap font is overkill here)."""
    for i, ch in enumerate(text[:64]):
        cx = x + i * 6
        if cx + 5 >= rgb.shape[1]:
            break
        code = ord(ch) & 0x7F
        for b in range(7):
            if code >> b & 1:
                yy = y + b
                if yy < rgb.shape[0]:
                    rgb[yy, cx : cx + 4] = (220, 220, 220)


def export_map_ply(path: str, points: np.ndarray, kf_positions: np.ndarray,
                   point_mask: np.ndarray | None = None) -> None:
    """MapDrawer analog: landmarks (white) + keyframe centers (green) as
    an ASCII PLY point cloud."""
    pts = np.asarray(points, np.float32)
    if point_mask is not None:
        pts = pts[np.asarray(point_mask, bool)]
    kfs = np.asarray(kf_positions, np.float32).reshape(-1, 3)
    n = len(pts) + len(kfs)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {n}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 200 200 200\n")
        for p in kfs:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} 0 255 60\n")


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>orbslam3_tpu map</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud"></div><canvas id="c"></canvas><script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.4, dist=0, cx=0, cy=0, czoom=1;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
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
let x1=cy1*x+sy*z, z1=-sy*x+cy1*z;
let y1=cp*y-sp*z1, z2=sp*y+cp*z1;
const s=scale*czoom;
return [cv.width/2+x1*s, cv.height/2+y1*s];}
let ctr=[0,0,0],scale=1;
function fit(){const P=DATA.points.concat(DATA.traj);if(!P.length)return;
let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
for(const p of P)for(let i=0;i<3;i++){mn[i]=Math.min(mn[i],p[i]);mx[i]=Math.max(mx[i],p[i]);}
ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
const ext=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-3);
scale=Math.min(innerWidth,innerHeight)*0.4/ext*2/2;}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
ctx.fillStyle='#c8c8c8';
for(const p of DATA.points){const q=proj(p);ctx.fillRect(q[0],q[1],1.5,1.5);}
ctx.strokeStyle='#2f6';ctx.beginPath();
DATA.traj.forEach((p,i)=>{const q=proj(p);i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});
ctx.stroke();
document.getElementById('hud').textContent=
`${DATA.points.length} landmarks | ${DATA.traj.length} keyframes | drag to orbit, wheel to zoom`;}
fit();resize();
</script></body></html>
"""


def export_map_html(path: str, points: np.ndarray, trajectory: np.ndarray,
                    point_mask: np.ndarray | None = None) -> None:
    """Interactive map+trajectory HTML (self-contained, no network)."""
    pts = np.asarray(points, np.float32)
    if point_mask is not None:
        pts = pts[np.asarray(point_mask, bool)]
    traj = np.asarray(trajectory, np.float32).reshape(-1, 3)
    data = json.dumps(
        {
            "points": np.round(pts, 4).tolist(),
            "traj": np.round(traj, 4).tolist(),
        }
    )
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", data))


class Viewer:
    """Offline analog of the Viewer thread: call `update(...)` per frame
    (cheap snapshot) and `finalize()` at shutdown to write the map
    exports — mirrors System's bUseViewer wiring (src/System.cc:259)."""

    def __init__(self, out_dir: str, frame_every: int = 0):
        self.out_dir = out_dir
        self.frame_every = frame_every
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, img, xy, valid, tracked, state: str = ""):
        if self.frame_every and self.n % self.frame_every == 0:
            rgb = draw_frame(img, xy, valid, tracked, state)
            save_png(os.path.join(self.out_dir, f"frame_{self.n:06d}.png"), rgb)
        self.n += 1

    def finalize(self, points, kf_positions, point_mask=None):
        export_map_ply(
            os.path.join(self.out_dir, "map.ply"), points, kf_positions, point_mask
        )
        export_map_html(
            os.path.join(self.out_dir, "map.html"), points, kf_positions, point_mask
        )
