"""In-browser 3D mesh preview — a self-contained WebGL HTML exporter.

Port of `omfs4d.app.viewer`: the scene is built on the host from
`TriMesh.numpy()`, so its JSON and HTML equal the reference's for the same
meshes.

The reference renders live cut-plane / segment previews with stpyvista
(a VTK render window streamed into streamlit, ref: app.py:768-798,
918-937).  VTK is not a dependency here; instead the session exports the
scene as a single standalone HTML file with an embedded first-party
WebGL1 renderer (~150 lines of JS: orbit/pan/zoom camera, headlight
lambert shading, per-mesh color/opacity, legend).  It needs no network,
no CDN, and renders in any browser — streamlit embeds it via
`components.html`, the CLI just writes the file.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from omfs4d_torch.ops.mesh import TriMesh

#: default segment styling (mirrors the reference's preview palette,
#: app.py:770-780 and 918-933)
SEGMENT_STYLES = {
    "maxilla": ("#fbbf24", 0.6),
    "mandible": ("#22d3d1", 0.6),
    "combined": ("#9ca3af", 0.6),
    "lefort": ("#ef4444", 0.3),
    "bsso_l": ("#3b82f6", 0.3),
    "bsso_r": ("#3b82f6", 0.3),
    "upper_skull": ("#6b7280", 0.5),
    "proximal_rami": ("#4b5563", 0.5),
    "mobile_maxilla": ("#f97316", 0.9),
    "distal_mandible": ("#3b82f6", 0.9),
}


def mesh_entry(name: str, mesh: TriMesh, color: str | None = None,
               opacity: float | None = None, max_faces: int = 20000) -> dict:
    """One scene entry: non-indexed triangle soup + flat per-face normals
    (computed host-side so the JS stays trivial)."""
    style = SEGMENT_STYLES.get(name, ("#9ca3af", 0.8))
    color = color or style[0]
    opacity = style[1] if opacity is None else opacity

    m = mesh
    if m.n_faces > max_faces:
        m = m.decimate(1.0 - max_faces / m.n_faces)
    verts, faces = m.numpy()
    v = verts[faces.reshape(-1)].astype(np.float32)            # (3F, 3)
    tri = v.reshape(-1, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    normals = np.repeat(n, 3, axis=0).astype(np.float32)
    return {
        "name": name,
        "color": color,
        "opacity": float(opacity),
        "positions": np.round(v, 4).reshape(-1).tolist(),
        "normals": np.round(normals, 3).reshape(-1).tolist(),
    }


def scene_payload(meshes: dict[str, TriMesh | None],
                  max_faces: int = 20000) -> list[dict]:
    """Scene list from a {name: mesh} dict (None / empty meshes skipped)."""
    out = []
    for name, mesh in meshes.items():
        if mesh is None or getattr(mesh, "n_points", 0) == 0:
            continue
        out.append(mesh_entry(name, mesh, max_faces=max_faces))
    return out


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#0e1117;color:#ddd;font:13px sans-serif;overflow:hidden}
 #legend{position:absolute;top:8px;left:8px;background:rgba(14,17,23,.8);
   padding:6px 10px;border-radius:6px}
 #legend div{display:flex;align-items:center;gap:6px;margin:2px 0}
 #legend span{width:12px;height:12px;border-radius:2px;display:inline-block}
 #hint{position:absolute;bottom:6px;left:8px;color:#888}
</style></head><body>
<canvas id="c"></canvas><div id="legend"></div>
<div id="hint">left-drag rotate &middot; right-drag pan &middot; scroll zoom</div>
<script>
const SCENE = __SCENE_JSON__;
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl', {alpha:false, antialias:true});
const VS = `attribute vec3 p; attribute vec3 n; uniform mat4 mvp; uniform mat4 mv;
 varying vec3 vn; varying vec3 vp;
 void main(){ gl_Position = mvp*vec4(p,1.0); vn=mat3(mv)*n; vp=(mv*vec4(p,1.0)).xyz; }`;
const FS = `precision mediump float; uniform vec3 col; uniform float op;
 varying vec3 vn; varying vec3 vp;
 void main(){ vec3 N=normalize(vn); vec3 L=normalize(-vp);
  float d=abs(dot(N,L)); gl_FragColor=vec4(col*(0.35+0.65*d), op); }`;
function shader(src, type){ const s=gl.createShader(type); gl.shaderSource(s,src);
 gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(VS, gl.VERTEX_SHADER));
gl.attachShader(prog, shader(FS, gl.FRAGMENT_SHADER));
gl.linkProgram(prog); gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'), aN=gl.getAttribLocation(prog,'n');
const uMVP=gl.getUniformLocation(prog,'mvp'), uMV=gl.getUniformLocation(prog,'mv');
const uCol=gl.getUniformLocation(prog,'col'), uOp=gl.getUniformLocation(prog,'op');
function hex(c){ return [1,3,5].map(i=>parseInt(c.slice(i,i+2),16)/255); }
// center + radius of the whole scene
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for(const m of SCENE){ const P=m.positions;
 for(let i=0;i<P.length;i+=3){ for(let k=0;k<3;k++){
  lo[k]=Math.min(lo[k],P[i+k]); hi[k]=Math.max(hi[k],P[i+k]); } } }
const ctr=[0,1,2].map(k=>(lo[k]+hi[k])/2);
const rad=Math.max(1e-6, Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])/2);
const meshes = SCENE.map(m=>{
 const buf=gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, buf);
 const P=m.positions, N=m.normals, inter=new Float32Array(P.length*2);
 for(let i=0,t=0;i<P.length;i+=3){ inter[t++]=P[i];inter[t++]=P[i+1];inter[t++]=P[i+2];
  inter[t++]=N[i];inter[t++]=N[i+1];inter[t++]=N[i+2]; }
 gl.bufferData(gl.ARRAY_BUFFER, inter, gl.STATIC_DRAW);
 const d=document.createElement('div');
 d.innerHTML='<span style="background:'+m.color+'"></span>'+m.name;
 document.getElementById('legend').appendChild(d);
 return {buf, count:P.length/3, color:hex(m.color), op:m.opacity}; });
meshes.sort((a,b)=>b.op-a.op);   // opaque-ish first
// camera state: xz view like the reference (camera_position="xz")
let yaw=0, pitch=-Math.PI/2, dist=rad*2.6, pan=[0,0];
function mat(){
 const aspect=canvas.width/canvas.height, f=1/Math.tan(0.4), zn=rad*0.01, zf=rad*20;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // rotate about ctr, then translate back by dist
 const R=[cy,sy*sp,-sy*cp, 0,cp,sp, sy,-cy*sp,cy*cp];
 const mv=new Float32Array(16);
 for(let c2=0;c2<3;c2++) for(let r=0;r<3;r++) mv[c2*4+r]=R[r*3+c2];
 const t=[0,1,2].map(k=>-(R[k*3]*ctr[0]+R[k*3+1]*ctr[1]+R[k*3+2]*ctr[2]));
 mv[12]=t[0]+pan[0]; mv[13]=t[1]+pan[1]; mv[14]=t[2]-dist; mv[15]=1;
 const pr=[f/aspect,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
 const mvp=new Float32Array(16);
 for(let c2=0;c2<4;c2++) for(let r=0;r<4;r++){ let s=0;
  for(let k=0;k<4;k++) s+=pr[k*4+r]*mv[c2*4+k]; mvp[c2*4+r]=s; }
 return {mv, mvp};
}
function draw(){
 canvas.width=innerWidth; canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.055,0.066,0.09,1); gl.enable(gl.DEPTH_TEST);
 gl.enable(gl.BLEND); gl.blendFunc(gl.SRC_ALPHA, gl.ONE_MINUS_SRC_ALPHA);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const {mv, mvp}=mat();
 gl.uniformMatrix4fv(uMVP,false,mvp); gl.uniformMatrix4fv(uMV,false,mv);
 for(const m of meshes){
  gl.bindBuffer(gl.ARRAY_BUFFER,m.buf);
  gl.enableVertexAttribArray(aP); gl.vertexAttribPointer(aP,3,gl.FLOAT,false,24,0);
  gl.enableVertexAttribArray(aN); gl.vertexAttribPointer(aN,3,gl.FLOAT,false,24,12);
  gl.uniform3fv(uCol,m.color); gl.uniform1f(uOp,m.op);
  gl.depthMask(m.op>0.7);
  gl.drawArrays(gl.TRIANGLES,0,m.count);
 }
 gl.depthMask(true);
}
let drag=null;
canvas.addEventListener('contextmenu',e=>e.preventDefault());
canvas.addEventListener('mousedown',e=>{drag={b:e.button,x:e.clientX,y:e.clientY};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{ if(!drag) return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y; drag.x=e.clientX; drag.y=e.clientY;
 if(drag.b===2){ pan[0]+=dx*dist*0.0015; pan[1]-=dy*dist*0.0015; }
 else { yaw+=dx*0.008; pitch+=dy*0.008;
  pitch=Math.max(-Math.PI,Math.min(Math.PI,pitch)); }
 draw(); });
canvas.addEventListener('wheel',e=>{ e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001); draw(); },{passive:false});
addEventListener('resize',draw);
draw();
</script></body></html>
"""


def scene_to_html(scene: list[dict], title: str = "omfs4d preview") -> str:
    """Standalone HTML document rendering the scene (no external assets)."""
    return (_HTML_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__SCENE_JSON__", json.dumps(scene)))


def write_preview(path: str | Path, meshes: dict[str, TriMesh | None],
                  title: str = "omfs4d preview", max_faces: int = 20000) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(scene_to_html(scene_payload(meshes, max_faces), title),
                 encoding="utf-8")
    return p
