"""Interactive trajectory/map viewer: a standalone HTML file.

Copy of ``monocular_visual_odometry_tpu.viz.viewer``. The file works from
``file://`` with no dependency: orbit/zoom with the mouse, left/right steps
one frame, space plays/pauses, ``r`` resets the view. It replays the
estimated trajectory with a camera frustum glyph at the current frame over
the final map cloud (intensity-shaded, the newest keyframe's points red).

Written by the CLI with ``--viewer`` (next to trajectory.png).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#101014;color:#d0d0d8;font:13px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;user-select:none;line-height:1.5}
 #help{position:fixed;right:10px;top:8px;text-align:right;color:#8a8a96}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="help">&larr;/&rarr; step &nbsp; space play/pause &nbsp; r reset<br>
drag orbit &nbsp; wheel zoom</div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, Hh; function resize(){W=cv.width=innerWidth;Hh=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});

// orbit-camera state (y-down world, like the image frame)
let yaw=-0.6, pitch=-0.45, dist=0, ctr=[0,0,0], frame=0, playing=false;
function resetView(){
  const P=D.est; let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  const all=P.concat(D.map.length?D.map:[]);
  for(const p of all) for(let i=0;i<3;i++){mn[i]=Math.min(mn[i],p[i]);mx[i]=Math.max(mx[i],p[i]);}
  ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  dist=2.2*Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-3);
  yaw=-0.6; pitch=-0.45;
}
resetView();

function proj(p){
  // world -> orbit camera -> perspective screen
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x=p[0]-ctr[0], y=p[1]-ctr[1], z=p[2]-ctr[2];
  let x1= cy*x+ sy*z, z1=-sy*x+ cy*z;            // yaw about y
  let y2= cp*y+ sp*z1, z2=-sp*y+ cp*z1;          // pitch about x
  z2 += dist;
  if (z2 < 1e-3) return null;
  const f = 0.9*Math.min(W,Hh);
  return [W/2 + f*x1/z2, Hh/2 + f*y2/z2, z2];
}
function line(a,b,st,w){const A=proj(a),B=proj(b); if(!A||!B)return;
  ctx.strokeStyle=st; ctx.lineWidth=w||1; ctx.beginPath();
  ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]); ctx.stroke();}
function dot(p,st,r){const A=proj(p); if(!A)return; ctx.fillStyle=st;
  ctx.fillRect(A[0]-r,A[1]-r,2*r,2*r);}

function draw(){
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,Hh);
  // map cloud: intensity-shaded; newest keyframe's points red
  for(let i=0;i<D.map.length;i++){
    const g=D.gray.length?D.gray[i]:160;
    dot(D.map[i], D.fresh[i]? 'rgb(235,80,70)'
        : `rgb(${40+0.55*g|0},${60+0.55*g|0},${90+0.5*g|0})`, 1.2);
  }
  // ground truth (if present): dim dashed
  if (D.gt.length){ctx.setLineDash([4,4]);
    for(let i=1;i<D.gt.length;i++) line(D.gt[i-1],D.gt[i],'#5a5a66',1);
    ctx.setLineDash([]);}
  // estimated trajectory up to the current frame
  for(let i=1;i<=frame;i++) line(D.est[i-1],D.est[i],'#49a6ff',2);
  for(const k of D.kf) if(k<=frame) dot(D.est[k],'#ffd257',2.5);
  // camera frustum glyph at the current frame (pcl_display camera glyph)
  const M=D.pose[frame], o=D.est[frame], s=D.glyph;
  function ax(v){return [o[0]+M[0]*v[0]+M[1]*v[1]+M[2]*v[2],
                         o[1]+M[3]*v[0]+M[4]*v[1]+M[5]*v[2],
                         o[2]+M[6]*v[0]+M[7]*v[1]+M[8]*v[2]];}
  const c4=[[-s,-0.75*s,1.6*s],[s,-0.75*s,1.6*s],[s,0.75*s,1.6*s],[-s,0.75*s,1.6*s]].map(ax);
  for(let i=0;i<4;i++){line(o,c4[i],'#7ef0a0',1.5); line(c4[i],c4[(i+1)%4],'#7ef0a0',1.5);}
  dot(o,'#7ef0a0',3);
  document.getElementById('hud').innerHTML =
    `frame ${frame+1}/${D.est.length} ${playing?'&#9654;':'&#10074;&#10074;'}`+
    `<br>${D.map.length} map points, ${D.kf.length} keyframes`+
    (D.gt.length?`<br>gt: dashed &nbsp; est: blue`:``);
}

// the waitKey loop (run_vo.cpp:317-323)
addEventListener('keydown', e=>{
  if(e.key==='ArrowRight') frame=Math.min(frame+1,D.est.length-1);
  else if(e.key==='ArrowLeft') frame=Math.max(frame-1,0);
  else if(e.key===' ') {playing=!playing; e.preventDefault();}
  else if(e.key==='r') resetView();
  draw();
});
setInterval(()=>{if(playing){frame=(frame+1)%D.est.length; draw();}}, 90);

let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008; pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); drag=[e.clientX,e.clientY]; draw();});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001); draw();
  e.preventDefault()},{passive:false});
draw();
</script></body></html>
"""


def export_viewer(
    est: np.ndarray,
    gt: Optional[np.ndarray] = None,
    map_pts: Optional[np.ndarray] = None,
    map_gray: Optional[np.ndarray] = None,
    map_created_idx: Optional[np.ndarray] = None,
    keyframe_indices: Optional[np.ndarray] = None,
    out_path: str = "viewer.html",
    title: str = "tpu-mono-vo viewer",
) -> str:
    """Write the standalone interactive viewer HTML.

    est: [N,4,4] estimated camera-to-world poses; gt: [M,4,4] or None;
    map_pts [P,3]; map_gray [P] per-landmark intensity (MapState.gray);
    map_created_idx [P] creation frame (newest batch drawn red);
    keyframe_indices: frame indices of keyframes (gold dots).
    """
    est = np.asarray(est, float)
    n = len(est)
    if n == 0:
        raise ValueError("empty trajectory")
    pos = est[:, :3, 3]
    rot = est[:, :3, :3].reshape(n, 9)
    mp = np.asarray(map_pts, float) if map_pts is not None else np.zeros((0, 3))
    gray = (np.asarray(map_gray, float).clip(0, 255)
            if map_gray is not None else np.zeros(0))
    if map_created_idx is not None and len(mp):
        created = np.asarray(map_created_idx)
        fresh = (created == created.max()).astype(int)
    else:
        fresh = np.zeros(len(mp), int)
    kf = (np.asarray(keyframe_indices, int)
          if keyframe_indices is not None else np.zeros(0, int))
    span = float(np.ptp(pos, axis=0).max()) if n > 1 else 1.0
    data = {
        "est": np.round(pos, 4).tolist(),
        "pose": np.round(rot, 4).tolist(),
        "gt": (np.round(np.asarray(gt, float)[:, :3, 3], 4).tolist()
               if gt is not None else []),
        "map": np.round(mp, 4).tolist(),
        "gray": np.round(gray, 0).astype(int).tolist(),
        "fresh": fresh.tolist(),
        "kf": kf.tolist(),
        "glyph": round(max(span, 1e-3) * 0.04, 5),
    }
    html = (_TEMPLATE
            .replace("__TITLE__", title)
            .replace("__DATA__", json.dumps(data, separators=(",", ":"))))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
