"""Interactive 3D scene visualiser (a standalone HTML file).

The port's own copy of `ratrack_tpu/utils/vis3d.py`, numpy only, over the
port's `data/vod.py`. The reference's k3d notebook visualiser
(`src/vod/visualization/vis_3d.py:9-246` + `helpers.py:10-206`): the
sensor-origin axis triads, radar / lidar point clouds, radial-velocity
vectors and class-coloured 3D label boxes, drawn by a self-contained WebGL
viewer embedded in one HTML file (`write_to_html` was the reference's
export too, vis_3d.py:239-246). Orbit / pan / zoom with the mouse; the
scene is embedded as JSON, which `parse_scene_html` reads back.

Beyond the reference: `add_track_points` draws the tracker's per-point
track memberships in an id-stable palette, as utils/vis.py does in BEV.

    python -m ratrack_tpu_torch.utils.vis3d --dataset <vod root> \\
        --frame 00549 --out frame.html [--origin camera] [--lidar] \\
        [--velocity] [--no-annotations] [--results <results>/<clip>/00549.txt]
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.vod import FrameData, ObjectLabel, Transforms, transform_points

# Reference palette/settings (src/vod/visualization/settings.py:8-39).
LABEL_COLOR_PALETTE_3D: Dict[str, int] = {
    "Car": 0xFF0000, "Pedestrian": 0x00FF00, "Cyclist": 0x0000FF,
    "bicycle": 0x0000FF, "DontCare": 0xAAAAAA, "moped_scooter": 0xAAAAAA,
    "rider": 0xFF0000, "bicycle_rack": 0xAAAAAA, "ride_other": 0xAAAAAA,
}
LABEL_LINE_WIDTH_3D: Dict[str, float] = {
    "Car": 0.05, "Pedestrian": 0.05, "Cyclist": 0.02, "bicycle": 0.05,
    "DontCare": 0.01, "moped_scooter": 0.05, "rider": 0.02,
    "bicycle_rack": 0.01, "ride_other": 0.01,
}
RADAR_COLOR = 0xFF0000        # settings.py:33
LIDAR_COLOR = 0x0000FF        # settings.py:34
VELOCITY_COLOR = 0xFF0000     # settings.py:36
RADAR_PCL_SIZE = 0.3          # settings.py:38
LIDAR_PCL_SIZE = 0.02         # settings.py:39
AXIS_LENGTH = 1.0
AXIS_LABEL_SIZE = 0.5

# id-stable categorical palette for track ids (matches utils/vis.py intent)
_TRACK_PALETTE = [
    0xE6194B, 0x3CB44B, 0xFFE119, 0x4363D8, 0xF58231, 0x911EB4,
    0x46F0F0, 0xF032E6, 0xBCF60C, 0xFABEBE, 0x008080, 0xE6BEFF,
    0x9A6324, 0xFFFAC8, 0x800000, 0xAAFFC3, 0x808000, 0xFFD8B1,
    0x000075, 0x808080,
]


def track_color(track_id: int) -> int:
    return _TRACK_PALETTE[int(track_id) % len(_TRACK_PALETTE)]


def label_corners_3d(label: ObjectLabel) -> np.ndarray:
    """Canonical (8, 3) box corners, bottom face first.

    Reference get_3d_label_corners (helpers.py:27-68): x = ±l/2,
    y = ±w/2, z = {0, h} — the box origin sits at the bottom-center.
    """
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float64) * label.l / 2
    y = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float64) * label.w / 2
    z = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float64) * label.h
    return np.stack([x, y, z], axis=1)


def transformed_label_corners(
        labels: Sequence[ObjectLabel], t_target_lidar: np.ndarray,
        t_camera_lidar: np.ndarray) -> List[dict]:
    """Label boxes → world-frame corner sets.

    Reference get_transformed_3d_label_corners (helpers.py:69-94): rotate
    the canonical corners by Rz(-(ry + π/2)), translate to the label
    center mapped camera→lidar, then transform lidar→target frame.
    """
    out = []
    t_lidar_camera = np.linalg.inv(t_camera_lidar)
    for lab in labels:
        rot = -(lab.ry + np.pi / 2)
        c, s = np.cos(rot), np.sin(rot)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        center = (t_lidar_camera @ np.array([lab.x, lab.y, lab.z, 1.0]))[:3]
        corners = label_corners_3d(lab) @ rz.T + center
        corners = transform_points(corners, t_target_lidar)
        out.append({"label_class": lab.type, "corners": corners,
                    "track_id": lab.id})
    return out


def radial_velocity_vectors(pc: np.ndarray, v_r: np.ndarray) -> np.ndarray:
    """Compensated radial velocity as 3D vectors along the radial unit
    direction (reference helpers.py:202-206)."""
    norm = np.linalg.norm(pc, axis=1, keepdims=True)
    norm = np.where(norm == 0, 1.0, norm)
    return v_r[:, None] * (pc / norm)


def default_camera(pose_transform: Optional[np.ndarray] = None) -> dict:
    """Reference get_default_camera (helpers.py:10-24): eye (-10, 0, 20),
    focus (10, 0, 1), up along +z, mapped through the given frame."""
    t = np.eye(4) if pose_transform is None else np.asarray(pose_transform)
    pts = np.array([[-10, 0, 20, 1], [10, 0, 1, 1], [0, 0, 90, 1]],
                   np.float64)
    posed = (t @ pts.T).T
    up = posed[2, :3] - posed[0, :3]
    up = up / max(np.linalg.norm(up), 1e-9)
    return {"eye": posed[0, :3].tolist(),
            "target": posed[1, :3].tolist(),
            "up": up.tolist()}


def _hex(color: int) -> str:
    return "#{:06x}".format(int(color) & 0xFFFFFF)


def parse_detection_labels(lines: Sequence[str]) -> List[ObjectLabel]:
    """Detection-format label lines → ObjectLabel list (id = line index).

    The reference's 3D visualizer reads the devkit label dir via
    FrameLabels (vis_3d.py:173; KITTI detection layout, data_loader.py:
    200-217): `type trunc occ alpha bbox(4) h w l x y z ry [score]`.
    Tokens 2..14 coincide with the tracking layout, but token 1 is the
    truncation/moving flag, not an id — parsing through
    parse_tracking_labels would collapse lines into at most two dict keys.
    """
    out = []
    for i, line in enumerate(lines):
        t = line.split(" ")
        if len(t) < 15:
            continue
        vals = [float(v) for v in t[1:15]]
        out.append(ObjectLabel(
            type=t[0], id=i, occ=vals[1], alpha=vals[2],
            bbox2d=np.array(vals[3:7], np.float32),
            h=vals[7], w=vals[8], l=vals[9],
            x=vals[10], y=vals[11], z=vals[12], ry=vals[13]))
    return out


class Scene3D:
    """Collects points / lines / vectors / texts; exports standalone HTML.

    The export embeds scene JSON plus a ~200-line WebGL orbit viewer; the
    JSON lives in a <script type="application/json" id="scene-data"> block
    so tests (and users) can parse the exact plotted data back out.
    """

    def __init__(self, title: str = "ratrack_tpu 3D"):
        self.title = title
        self.points: List[dict] = []
        self.lines: List[dict] = []
        self.texts: List[dict] = []
        self.camera = default_camera()

    # -- builders ---------------------------------------------------------
    def add_points(self, xyz: np.ndarray, color: int = 0xFFFFFF,
                   size: float = 0.05, name: str = "points",
                   colors: Optional[np.ndarray] = None) -> "Scene3D":
        xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
        entry = {"name": name, "size": float(size),
                 "xyz": np.round(xyz, 4).flatten().tolist()}
        if colors is not None:
            entry["colors"] = [int(c) for c in np.asarray(colors).ravel()]
        else:
            entry["color"] = int(color)
        self.points.append(entry)
        return self

    def add_lines(self, segments: np.ndarray, color: int = 0xFFFFFF,
                  width: float = 0.02, name: str = "lines") -> "Scene3D":
        """segments: (S, 2, 3) endpoint pairs."""
        seg = np.asarray(segments, np.float64).reshape(-1, 2, 3)
        self.lines.append({"name": name, "color": int(color),
                           "width": float(width),
                           "xyz": np.round(seg, 4).flatten().tolist()})
        return self

    def add_vectors(self, origins: np.ndarray, vectors: np.ndarray,
                    color: int = VELOCITY_COLOR,
                    name: str = "vectors") -> "Scene3D":
        o = np.asarray(origins, np.float64).reshape(-1, 3)
        v = np.asarray(vectors, np.float64).reshape(-1, 3)
        return self.add_lines(np.stack([o, o + v], axis=1), color=color,
                              name=name)

    def add_box(self, corners: np.ndarray, color: int,
                width: float = 0.05, name: str = "box") -> "Scene3D":
        """corners: (8, 3) with bottom face 0-3, top face 4-7 (reference
        k3d_plot_box edge topology, helpers.py:195-199)."""
        c = np.asarray(corners, np.float64).reshape(8, 3)
        ring = [0, 1, 2, 3, 0]
        segs = []
        for a, b in zip(ring[:-1], ring[1:]):
            segs.append([c[a], c[b]])
            segs.append([c[a + 4], c[b + 4]])
        for a in range(4):
            segs.append([c[a], c[a + 4]])
        return self.add_lines(np.asarray(segs), color=color, width=width,
                              name=name)

    def add_axes(self, transform: np.ndarray,
                 length: float = AXIS_LENGTH) -> "Scene3D":
        """RGB triad at a frame origin (reference k3d_get_axes,
        helpers.py:172-193)."""
        t = np.asarray(transform, np.float64)
        origin = t[:3, 3]
        for axis, color in zip(range(3), (0xFF0000, 0x00FF00, 0x0000FF)):
            tip = (t @ np.concatenate(
                [np.eye(3)[axis] * length, [1.0]]))[:3]
            self.add_lines(np.asarray([[origin, tip]]), color=color,
                           name=f"axis{axis}")
        return self

    def add_text(self, position: np.ndarray, text: str,
                 color: int = 0xFFFFFF,
                 size: float = AXIS_LABEL_SIZE) -> "Scene3D":
        self.texts.append({"pos": np.asarray(position, np.float64)[:3]
                           .tolist(),
                           "text": str(text), "color": _hex(color),
                           "size": float(size)})
        return self

    def add_track_points(self, points: np.ndarray, track_ids: np.ndarray,
                         valid: Optional[np.ndarray] = None,
                         size: float = 0.25) -> "Scene3D":
        """Framework outputs: per-point positions colored by track id."""
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        tid = np.asarray(track_ids).reshape(-1)
        keep = tid >= 0
        if valid is not None:
            keep &= np.asarray(valid, bool).reshape(-1)
        pts, tid = pts[keep], tid[keep]
        colors = np.array([track_color(t) for t in tid], np.int64)
        return self.add_points(pts, colors=colors, size=size, name="tracks")

    # -- export -----------------------------------------------------------
    def scene_dict(self) -> dict:
        return {"title": self.title, "camera": self.camera,
                "points": self.points, "lines": self.lines,
                "texts": self.texts}

    def to_html(self, path: str) -> str:
        data = json.dumps(self.scene_dict())
        html = (_HTML_TEMPLATE
                .replace("__TITLE__", self.title)
                .replace("__SCENE_JSON__", data))
        with open(path, "w") as f:
            f.write(html)
        return path


def parse_scene_html(path: str) -> dict:
    """Parse the embedded scene JSON back out of an exported HTML file."""
    with open(path) as f:
        html = f.read()
    start = html.index('<script type="application/json" id="scene-data">')
    start = html.index(">", start) + 1
    end = html.index("</script>", start)
    return json.loads(html[start:end])


class Visualization3D:
    """Reference-API 3D frame visualizer over FrameData + Transforms.

    Mirrors `src/vod/visualization/vis_3d.py:9-246`: same constructor
    signature (frame_data, origin ∈ {camera, lidar, radar}), same plot
    toggles, same per-element colors/sizes, HTML export instead of k3d
    widget display.
    """

    def __init__(self, frame_data: FrameData, origin: str = "camera"):
        self.frame_data = frame_data
        self.transforms = Transforms(frame_data)
        tr = self.transforms
        if origin == "camera":
            self.transform_matrices = {
                "camera": np.eye(4), "lidar": tr.t_camera_lidar,
                "radar": tr.t_camera_radar}
        elif origin == "lidar":
            self.transform_matrices = {
                "camera": tr.t_lidar_camera, "lidar": np.eye(4),
                "radar": tr.t_lidar_radar}
        elif origin == "radar":
            self.transform_matrices = {
                "camera": tr.t_radar_camera, "lidar": tr.t_radar_lidar,
                "radar": np.eye(4)}
        else:
            raise ValueError("Origin must be camera, lidar or radar!")
        self.origin = origin
        self.scene = Scene3D(title=f"frame {frame_data.frame_number} "
                                   f"({origin} origin)")

    # -- elements (reference vis_3d.py:63-188) ----------------------------
    def plot_radar_origin(self):
        t = self.transform_matrices["radar"]
        self.scene.add_axes(t)
        self.scene.add_text(t[:3, 3], "radar", RADAR_COLOR)

    def plot_lidar_origin(self):
        t = self.transform_matrices["lidar"]
        self.scene.add_axes(t)
        self.scene.add_text(t[:3, 3], "lidar", LIDAR_COLOR)

    def plot_camera_origin(self):
        t = self.transform_matrices["camera"]
        self.scene.add_axes(t)
        self.scene.add_text(t[:3, 3], "camera", LIDAR_COLOR)

    def plot_radar_points(self, pcl_size: float = RADAR_PCL_SIZE,
                          color: int = RADAR_COLOR):
        pts = transform_points(self.frame_data.radar[:, :3],
                               self.transform_matrices["radar"])
        self.scene.add_points(pts, color=color, size=pcl_size, name="radar")

    def plot_lidar_points(self, pcl_size: float = LIDAR_PCL_SIZE,
                          color: int = LIDAR_COLOR):
        pts = transform_points(self.frame_data.lidar[:, :3],
                               self.transform_matrices["lidar"])
        self.scene.add_points(pts, color=color, size=pcl_size, name="lidar")

    def plot_radar_radial_velocity(self, color: int = VELOCITY_COLOR):
        """Compensated radial velocity vectors (vis_3d.py:153-166; note the
        reference builds the unit directions from the TRANSFORMED points —
        reproduced, camera-origin vectors differ from radar-origin ones)."""
        pts = transform_points(self.frame_data.radar[:, :3],
                               self.transform_matrices["radar"])
        v_r = self.frame_data.radar[:, 5]
        self.scene.add_vectors(pts, radial_velocity_vectors(pts, v_r),
                               color=color, name="radar_velocity")

    def plot_annotations(self, class_colors=None, class_width=None):
        """Class-colored label boxes (vis_3d.py:168-188): corners built in
        the lidar frame, then mapped through the lidar→origin transform.
        Reads the detection label dir, as the reference's FrameLabels
        does (its raw_labels property)."""
        class_colors = class_colors or LABEL_COLOR_PALETTE_3D
        class_width = class_width or LABEL_LINE_WIDTH_3D
        labels = parse_detection_labels(self.frame_data.detection_labels)
        boxes = transformed_label_corners(
            labels, self.transform_matrices["lidar"],
            self.transforms.t_camera_lidar)
        for box in boxes:
            cls = box["label_class"]
            self.scene.add_box(
                box["corners"],
                color=class_colors.get(cls, 0xAAAAAA),
                width=class_width.get(cls, 0.01),
                name=f"label:{cls}:{box['track_id']}")

    def draw_plot(self, radar_origin_plot=False, lidar_origin_plot=False,
                  camera_origin_plot=False, lidar_points_plot=False,
                  radar_points_plot=False, radar_velocity_plot=False,
                  annotations_plot=False, write_to_html=False,
                  html_name="example") -> Optional[str]:
        if radar_origin_plot:
            self.plot_radar_origin()
        if lidar_origin_plot:
            self.plot_lidar_origin()
        if camera_origin_plot:
            self.plot_camera_origin()
        if lidar_points_plot:
            self.plot_lidar_points()
        if radar_points_plot:
            self.plot_radar_points()
        if radar_velocity_plot:
            self.plot_radar_radial_velocity()
        if annotations_plot:
            self.plot_annotations()
        self.scene.camera = default_camera(
            self.transform_matrices["lidar"])
        if write_to_html:
            return self.scene.to_html(f"{html_name}.html")
        return None


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ccc;
  font:12px sans-serif;overflow:hidden}
 #gl,#overlay{position:absolute;inset:0;width:100%;height:100%}
 #overlay{pointer-events:none}
 #hud{position:absolute;left:8px;top:8px;opacity:.8}
</style></head><body>
<canvas id="gl"></canvas><canvas id="overlay"></canvas>
<div id="hud">__TITLE__ — drag: orbit · shift-drag: pan · wheel: zoom</div>
<script type="application/json" id="scene-data">__SCENE_JSON__</script>
<script>
const S=JSON.parse(document.getElementById('scene-data').textContent);
const cv=document.getElementById('gl'),ov=document.getElementById('overlay');
const gl=cv.getContext('webgl');
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
 gl.compileShader(o);return o}
function prog(v,f){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,v));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,f));gl.linkProgram(p);return p}
const PV=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
 uniform float ps;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.);
 gl_PointSize=max(1.5,ps/max(gl_Position.w,.1));vc=c;}`;
const PF=`precision mediump float;varying vec3 vc;
 void main(){vec2 d=gl_PointCoord-vec2(.5);
 if(dot(d,d)>.25)discard;gl_FragColor=vec4(vc,1.);}`;
const pp=prog(PV,PF);
function hex(c){return[(c>>16&255)/255,(c>>8&255)/255,(c&255)/255]}
// buffers
const draws=[];
for(const P of S.points){const n=P.xyz.length/3;
 const pos=new Float32Array(P.xyz);let col=new Float32Array(n*3);
 if(P.colors){for(let i=0;i<n;i++){const c=hex(P.colors[i]);
  col.set(c,i*3);}}else{const c=hex(P.color);
  for(let i=0;i<n;i++)col.set(c,i*3);}
 const b1=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b1);
 gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
 const b2=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b2);
 gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
 draws.push({mode:gl.POINTS,pos:b1,col:b2,n:n,ps:P.size*60});}
for(const L of S.lines){const n=L.xyz.length/3;
 const pos=new Float32Array(L.xyz);const col=new Float32Array(n*3);
 const c=hex(L.color);for(let i=0;i<n;i++)col.set(c,i*3);
 const b1=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b1);
 gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
 const b2=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b2);
 gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
 draws.push({mode:gl.LINES,pos:b1,col:b2,n:n,ps:1});}
// matrices
function m4mul(a,b){const o=new Array(16);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s}return o}
function persp(f,a,n,fa){const t=1/Math.tan(f/2);
 return[t/a,0,0,0,0,t,0,0,0,0,(fa+n)/(n-fa),-1,0,0,2*fa*n/(n-fa),0]}
function lookAt(e,t,u){function nm(v){const l=Math.hypot(...v);
  return v.map(x=>x/l)}
 function cr(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]]}
 const z=nm([e[0]-t[0],e[1]-t[1],e[2]-t[2]]);const x=nm(cr(u,z));
 const y=cr(z,x);
 return[x[0],y[0],z[0],0,x[1],y[1],z[1],0,x[2],y[2],z[2],0,
  -(x[0]*e[0]+x[1]*e[1]+x[2]*e[2]),-(y[0]*e[0]+y[1]*e[1]+y[2]*e[2]),
  -(z[0]*e[0]+z[1]*e[1]+z[2]*e[2]),1]}
// camera state from scene
let target=S.camera.target.slice(),up=S.camera.up.slice();
let eye=S.camera.eye.slice();
let dv=[eye[0]-target[0],eye[1]-target[1],eye[2]-target[2]];
let radius=Math.hypot(...dv);
let theta=Math.atan2(dv[1],dv[0]),phi=Math.acos(dv[2]/radius);
let drag=0,px=0,py=0;
cv.style.pointerEvents='auto';
document.addEventListener('mousedown',e=>{drag=e.shiftKey?2:1;
 px=e.clientX;py=e.clientY});
document.addEventListener('mouseup',()=>drag=0);
document.addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(drag==1){theta-=dx*.008;phi=Math.min(Math.PI-.05,
  Math.max(.05,phi-dy*.008));}
 else{const s=radius*.002;
  target[0]-=dx*s*Math.sin(theta);target[1]+=dx*s*Math.cos(theta);
  target[2]+=dy*s;}});
document.addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*.001);});
function frame(){
 const w=innerWidth,h=innerHeight;
 if(cv.width!=w||cv.height!=h){cv.width=ov.width=w;cv.height=ov.height=h}
 eye=[target[0]+radius*Math.sin(phi)*Math.cos(theta),
      target[1]+radius*Math.sin(phi)*Math.sin(theta),
      target[2]+radius*Math.cos(phi)];
 const mvp=m4mul(persp(1.0,w/h,.1,radius*40+100),lookAt(eye,target,up));
 gl.viewport(0,0,w,h);gl.enable(gl.DEPTH_TEST);
 gl.clearColor(.07,.07,.07,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.useProgram(pp);
 const uM=gl.getUniformLocation(pp,'mvp'),
  uS=gl.getUniformLocation(pp,'ps'),
  aP=gl.getAttribLocation(pp,'p'),aC=gl.getAttribLocation(pp,'c');
 gl.uniformMatrix4fv(uM,false,new Float32Array(mvp));
 for(const d of draws){gl.uniform1f(uS,d.ps);
  gl.bindBuffer(gl.ARRAY_BUFFER,d.pos);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,d.col);
  gl.enableVertexAttribArray(aC);
  gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(d.mode,0,d.n);}
 // text overlay
 const cx=ov.getContext('2d');cx.clearRect(0,0,w,h);
 cx.font='13px sans-serif';
 for(const T of S.texts){
  const p=T.pos,m=mvp;
  const X=m[0]*p[0]+m[4]*p[1]+m[8]*p[2]+m[12],
        Y=m[1]*p[0]+m[5]*p[1]+m[9]*p[2]+m[13],
        W=m[3]*p[0]+m[7]*p[1]+m[11]*p[2]+m[15];
  if(W>0){cx.fillStyle=T.color;
   cx.fillText(T.text,(X/W*.5+.5)*w,(-Y/W*.5+.5)*h);}}
 requestAnimationFrame(frame);}
frame();
</script></body></html>
"""


def main(argv=None):
    """CLI: render a VoD frame (and optionally tracker results) to HTML.

    The reference's 3D view only exists inside Jupyter notebooks
    (vis_3d.py used via the devkit notebooks); this makes the same scene
    a one-liner:

        python -m ratrack_tpu_torch.utils.vis3d --dataset <vod root> \\
            --frame 00549 --out frame.html [--origin camera] \\
            [--lidar] [--velocity] [--no-annotations] \\
            [--results results/<clip>/00549.txt]
    """
    import argparse
    p = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True, help="VoD root directory")
    p.add_argument("--frame", required=True, help="frame number, e.g. 00549")
    p.add_argument("--out", required=True, help="output .html path")
    p.add_argument("--origin", default="camera",
                   choices=("camera", "lidar", "radar"))
    p.add_argument("--lidar", action="store_true",
                   help="include the lidar cloud")
    p.add_argument("--velocity", action="store_true",
                   help="radar radial-velocity vectors")
    p.add_argument("--no-annotations", action="store_true")
    p.add_argument("--results", default=None,
                   help="per-frame tracker dump (eval/export format) to "
                        "overlay as id-colored track points")
    args = p.parse_args(argv)

    from ..data.vod import VodLocations
    frame = FrameData(VodLocations(args.dataset), args.frame)
    vis = Visualization3D(frame, origin=args.origin)
    vis.draw_plot(
        radar_origin_plot=True, lidar_origin_plot=True,
        camera_origin_plot=True, radar_points_plot=True,
        lidar_points_plot=args.lidar, radar_velocity_plot=args.velocity,
        annotations_plot=not args.no_annotations)
    if args.results:
        from ..eval.export import parse_frame_results
        tracks = parse_frame_results(args.results)
        # dumps are in the radar frame; map into the chosen origin
        t = vis.transform_matrices["radar"]
        for conf, tid, pts in tracks:
            vis.scene.add_points(
                transform_points(pts.astype(np.float64), t),
                color=track_color(tid), size=0.35, name=f"track:{tid}")
            if pts.shape[0]:
                center = transform_points(
                    pts.mean(axis=0, keepdims=True).astype(np.float64), t)
                vis.scene.add_text(center[0], f"id {tid} ({conf:.2f})",
                                   track_color(tid))
    out = vis.scene.to_html(args.out)
    print(f"wrote {out} ({len(vis.scene.points)} point sets, "
          f"{len(vis.scene.lines)} line sets)")


if __name__ == "__main__":
    main()
