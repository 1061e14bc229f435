// dash3d client: websocket geometry stream -> WebGL render.
// Wire format (see util.py): 'KAO1' | u32 type | u32 n | per-array
// (u32 dtype, u32 ndim, u32 shape[ndim], payload).

'use strict';

function parseBinary(buffer) {
  const dv = new DataView(buffer);
  const magic = String.fromCharCode(dv.getUint8(0), dv.getUint8(1),
                                    dv.getUint8(2), dv.getUint8(3));
  if (magic !== 'KAO1') throw new Error('bad magic');
  const msgType = dv.getUint32(4, true);
  const numArrays = dv.getUint32(8, true);
  let off = 12;
  const arrays = [];
  for (let i = 0; i < numArrays; i++) {
    const dtype = dv.getUint32(off, true); off += 4;
    const ndim = dv.getUint32(off, true); off += 4;
    const shape = [];
    let count = 1;
    for (let d = 0; d < ndim; d++) {
      const s = dv.getUint32(off, true); off += 4;
      shape.push(s); count *= s;
    }
    const ctor = dtype === 1 ? Uint32Array : Float32Array;
    arrays.push({shape: shape,
                 data: new ctor(buffer.slice(off, off + 4 * count))});
    off += 4 * count;
  }
  return {msgType: msgType, arrays: arrays};
}

const VS = `
attribute vec3 position;
uniform mat4 mvp;
varying float depth;
void main() {
  gl_Position = mvp * vec4(position, 1.0);
  gl_PointSize = 3.0;
  depth = gl_Position.z / gl_Position.w;
}`;
const FS = `
precision mediump float;
varying float depth;
void main() {
  float shade = clamp(1.0 - 0.5 * depth, 0.2, 1.0);
  gl_FragColor = vec4(0.4 * shade, 0.7 * shade, 1.0 * shade, 1.0);
}`;

class Viewer {
  constructor(canvas) {
    this.canvas = canvas;
    this.gl = canvas.getContext('webgl');
    const gl = this.gl;
    const prog = gl.createProgram();
    for (const [type, src] of [[gl.VERTEX_SHADER, VS],
                               [gl.FRAGMENT_SHADER, FS]]) {
      const sh = gl.createShader(type);
      gl.shaderSource(sh, src);
      gl.compileShader(sh);
      gl.attachShader(prog, sh);
    }
    gl.linkProgram(prog);
    gl.useProgram(prog);
    this.prog = prog;
    this.posLoc = gl.getAttribLocation(prog, 'position');
    this.mvpLoc = gl.getUniformLocation(prog, 'mvp');
    this.vbo = gl.createBuffer();
    this.ibo = gl.createBuffer();
    this.numIndices = 0;
    this.numPoints = 0;
    this.isMesh = true;
    this.azimuth = 0.7; this.elevation = 0.4; this.distance = 3.0;
    this.center = [0, 0, 0];
    this._bindControls();
  }

  setGeometry(msg) {
    const gl = this.gl;
    const verts = msg.arrays[0];
    gl.bindBuffer(gl.ARRAY_BUFFER, this.vbo);
    gl.bufferData(gl.ARRAY_BUFFER, verts.data, gl.STATIC_DRAW);
    // center + scale from bbox
    let mn = [1e9, 1e9, 1e9], mx = [-1e9, -1e9, -1e9];
    for (let i = 0; i < verts.data.length; i += 3)
      for (let a = 0; a < 3; a++) {
        mn[a] = Math.min(mn[a], verts.data[i + a]);
        mx[a] = Math.max(mx[a], verts.data[i + a]);
      }
    this.center = [(mn[0]+mx[0])/2, (mn[1]+mx[1])/2, (mn[2]+mx[2])/2];
    this.distance = 2.0 * Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 0.1);
    this.isMesh = msg.msgType === 1 && msg.arrays.length > 1;
    if (this.isMesh) {
      const faces = msg.arrays[1];
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.ibo);
      // Uint32 indices need OES_element_index_uint; convert if small
      const ext = gl.getExtension('OES_element_index_uint');
      const data = ext ? faces.data : new Uint16Array(faces.data);
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, data, gl.STATIC_DRAW);
      this.indexType = ext ? gl.UNSIGNED_INT : gl.UNSIGNED_SHORT;
      this.numIndices = faces.data.length;
    } else {
      this.numPoints = verts.data.length / 3;
    }
    this.draw();
  }

  mvp() {
    const az = this.azimuth, el = this.elevation, d = this.distance;
    const eye = [this.center[0] + d * Math.cos(el) * Math.sin(az),
                 this.center[1] + d * Math.sin(el),
                 this.center[2] + d * Math.cos(el) * Math.cos(az)];
    const look = lookAt(eye, this.center, [0, 1, 0]);
    const proj = perspective(45 * Math.PI / 180,
                             this.canvas.width / this.canvas.height,
                             0.01, 100.0);
    return matmul(proj, look);
  }

  draw() {
    const gl = this.gl;
    gl.viewport(0, 0, this.canvas.width, this.canvas.height);
    gl.clearColor(0.12, 0.12, 0.12, 1.0);
    gl.enable(gl.DEPTH_TEST);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    gl.bindBuffer(gl.ARRAY_BUFFER, this.vbo);
    gl.enableVertexAttribArray(this.posLoc);
    gl.vertexAttribPointer(this.posLoc, 3, gl.FLOAT, false, 0, 0);
    gl.uniformMatrix4fv(this.mvpLoc, false, this.mvp());
    if (this.isMesh && this.numIndices > 0) {
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, this.ibo);
      gl.drawElements(gl.TRIANGLES, this.numIndices, this.indexType, 0);
    } else if (this.numPoints > 0) {
      gl.drawArrays(gl.POINTS, 0, this.numPoints);
    }
  }

  _bindControls() {
    let dragging = false, lx = 0, ly = 0;
    this.canvas.addEventListener('mousedown', e => {
      dragging = true; lx = e.clientX; ly = e.clientY;
    });
    window.addEventListener('mouseup', () => { dragging = false; });
    window.addEventListener('mousemove', e => {
      if (!dragging) return;
      this.azimuth += (e.clientX - lx) * 0.01;
      this.elevation = Math.max(-1.5, Math.min(1.5,
          this.elevation + (e.clientY - ly) * 0.01));
      lx = e.clientX; ly = e.clientY;
      this.draw();
    });
    this.canvas.addEventListener('wheel', e => {
      this.distance *= Math.exp(e.deltaY * 0.001);
      this.draw();
      e.preventDefault();
    });
  }
}

// ---- small matrix helpers (column-major, WebGL convention) ----
function lookAt(eye, at, up) {
  const f = norm3(sub3(at, eye));
  const s = norm3(cross3(f, up));
  const u = cross3(s, f);
  return new Float32Array([
    s[0], u[0], -f[0], 0,
    s[1], u[1], -f[1], 0,
    s[2], u[2], -f[2], 0,
    -dot3(s, eye), -dot3(u, eye), dot3(f, eye), 1]);
}
function perspective(fovy, aspect, near, far) {
  const t = 1.0 / Math.tan(fovy / 2);
  const nf = 1 / (near - far);
  return new Float32Array([
    t / aspect, 0, 0, 0,
    0, t, 0, 0,
    0, 0, (far + near) * nf, -1,
    0, 0, 2 * far * near * nf, 0]);
}
function matmul(a, b) {
  const out = new Float32Array(16);
  for (let c = 0; c < 4; c++)
    for (let r = 0; r < 4; r++) {
      let acc = 0;
      for (let k = 0; k < 4; k++) acc += a[k * 4 + r] * b[c * 4 + k];
      out[c * 4 + r] = acc;
    }
  return out;
}
function sub3(a, b) { return [a[0]-b[0], a[1]-b[1], a[2]-b[2]]; }
function dot3(a, b) { return a[0]*b[0] + a[1]*b[1] + a[2]*b[2]; }
function cross3(a, b) {
  return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]];
}
function norm3(a) {
  const l = Math.sqrt(dot3(a, a)) || 1;
  return [a[0]/l, a[1]/l, a[2]/l];
}

// ---- app wiring ----
const viewer = new Viewer(document.getElementById('view'));
let summary = null;
const sel = document.getElementById('geometry');
const timeSlider = document.getElementById('time');
const timeLabel = document.getElementById('time-label');
const ws = new WebSocket(
    (location.protocol === 'https:' ? 'wss://' : 'ws://')
    + location.host + '/websocket');
ws.binaryType = 'arraybuffer';
ws.onmessage = e => {
  if (typeof e.data === 'string') { console.warn(e.data); return; }
  viewer.setGeometry(parseBinary(e.data));
};

function currentItem() {
  if (!summary) return null;
  const [typ, idx] = sel.value.split('#');
  return {type: typ, item: summary[typ][parseInt(idx)]};
}
function request() {
  const cur = currentItem();
  if (!cur || ws.readyState !== 1) return;
  const ts = cur.item.timestamps;
  const t = ts.length ? ts[Math.min(parseInt(timeSlider.value),
                                    ts.length - 1)] : null;
  timeLabel.textContent = 't=' + t;
  ws.send(JSON.stringify({type: cur.type, category: cur.item.category,
                          id: cur.item.id, time: t}));
}
function refreshSummary() {
  fetch('/summary').then(r => r.json()).then(data => {
    summary = data;
    sel.innerHTML = '';
    for (const typ of ['mesh', 'pointcloud']) {
      (data[typ] || []).forEach((item, i) => {
        const opt = document.createElement('option');
        opt.value = typ + '#' + i;
        opt.textContent = `${typ} ${item.category}/${item.id}`;
        sel.appendChild(opt);
      });
    }
    const cur = currentItem();
    if (cur) {
      timeSlider.max = Math.max(0, cur.item.timestamps.length - 1);
      request();
    }
  });
}
sel.onchange = () => { const c = currentItem();
  if (c) timeSlider.max = Math.max(0, c.item.timestamps.length - 1);
  request(); };
timeSlider.oninput = request;
document.getElementById('refresh').onclick = refreshSummary;
ws.onopen = refreshSummary;
