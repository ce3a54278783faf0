"""Minimal in-repo ONNX runtime on torch (parser + torch executor).

Counterpart of univid_tpu/data/onnx_rt.py. The reference's animate
preprocess runs its neural detectors (YOLO person detection and ViTPose
wholebody heatmaps) through onnxruntime sessions; the JAX package runs
them in numpy on the host. Here the same graphs run as torch ops on the
session's device, so on the card the detectors run there:

  * the protobuf wire-format parser for ModelProto, copied as it is from
    the JAX package (no `onnx` package, no generated code: the ONNX schema
    field numbers are pinned below);
  * a graph executor over the op set of the numpy executor (Conv and
    ConvTranspose through cuDNN with TF32 off, pooling, Resize in its own
    coordinate modes, MatMul / Gemm / Softmax / LayerNormalization / Erf,
    the shape ops, TopK, ArgMax and NonMaxSuppression).

Every op returns what the numpy executor returns, dtype included (numpy's
promotion: a float32 tensor divided by an np.float64 scalar is float64,
an integer Div is a float64 true division, Mod is fmod). A value lives on
the host (a CPU tensor) or on the device: shapes, constants, small
initializers and everything computed only from them (Shape, Gather on a
shape, Concat, Range, ConstantOfShape) stay on the host as int64, so the
shape plumbing of a ViT export costs no device sync; a host value joins a
device op by an asynchronous copy. Ties in TopK and ArgMax resolve as
numpy's stable order does. NonMaxSuppression is greedy host work, as in
the JAX package.

This is NOT a general ONNX implementation: unsupported ops raise with the
op name, and only 2-D convolutions are implemented. Execution order is the
node order in the graph, which the ONNX spec requires to be topologically
sorted.

Usage:
    sess = OnnxSession("vitpose_h_wholebody.onnx", device="cuda")
    (heat,) = sess.run(None, {"input": x})    # ort-like API, numpy out
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.nn import exact_fp32

# ---------------------------------------------------------------------------
# protobuf wire-format parsing (schema: onnx/onnx.proto3)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    v = s = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, i
        s += 7


def _signed(v: int) -> int:
    """proto int64 fields encode negatives as 10-byte varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, raw_value) triples."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fn, wt, v


def _packed_varints(buf: bytes) -> List[int]:
    out, i = [], 0
    while i < len(buf):
        v, i = _varint(buf, i)
        out.append(_signed(v))
    return out


# TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1 name=8 data_type=2 raw_data=9 float_data=4
    int32_data=5 int64_data=7 double_data=10 uint64_data=11."""
    dims: List[int] = []
    name = ""
    dtype_code = 1
    raw: Optional[bytes] = None
    f32: List[float] = []
    i32: List[int] = []
    i64: List[int] = []
    f64: List[float] = []
    for fn, wt, v in _fields(buf):
        if fn == 1:
            dims.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fn == 2:
            dtype_code = v
        elif fn == 4:
            if wt == 2:
                f32.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                f32.append(struct.unpack("<f", v)[0])
        elif fn == 5:
            i32.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fn == 7:
            i64.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fn == 8:
            name = v.decode()
        elif fn == 9:
            raw = bytes(v)
        elif fn == 10:
            if wt == 2:
                f64.extend(struct.unpack(f"<{len(v) // 8}d", v))
            else:
                f64.append(struct.unpack("<d", v)[0])
    dt = _DTYPES.get(dtype_code)
    if dt is None:
        raise ValueError(f"tensor '{name}': unsupported data_type "
                         f"{dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt)
    elif f32:
        arr = np.asarray(f32, np.float32).astype(dt)
    elif i64:
        arr = np.asarray(i64, np.int64).astype(dt)
    elif i32:
        # int32_data also carries int8/16/bool/fp16 payloads per spec
        arr = np.asarray(i32, np.int32)
        arr = arr.astype(np.uint16).view(np.float16) \
            if dt == np.float16 else arr.astype(dt)
    elif f64:
        arr = np.asarray(f64, np.float64).astype(dt)
    else:
        arr = np.zeros(0, dt)
    return name, arr.reshape(dims).copy()


def _parse_attribute(buf: bytes):
    """AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 strings=9."""
    name = ""
    val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fn, wt, v in _fields(buf):
        if fn == 1:
            name = v.decode()
        elif fn == 2:
            val = struct.unpack("<f", v)[0]
        elif fn == 3:
            val = _signed(v)
        elif fn == 4:
            val = bytes(v)
        elif fn == 5:
            val = _parse_tensor(v)[1]
        elif fn == 7:
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif fn == 8:
            ints.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fn == 9:
            strings.append(bytes(v))
    if floats:
        val = floats
    elif ints:
        val = ints
    elif strings:
        val = strings
    return name, val


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, buf: bytes):
        self.op = ""
        self.name = ""
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.attrs: Dict[str, object] = {}
        for fn, _wt, v in _fields(buf):
            if fn == 1:
                self.inputs.append(v.decode())
            elif fn == 2:
                self.outputs.append(v.decode())
            elif fn == 3:
                self.name = v.decode()
            elif fn == 4:
                self.op = v.decode()
            elif fn == 5:
                k, val = _parse_attribute(v)
                self.attrs[k] = val


def _parse_value_info(buf: bytes) -> Tuple[str, Optional[List[int]]]:
    """ValueInfoProto -> (name, dims or None); dim_param -> None entry."""
    name = ""
    dims: Optional[List[int]] = None
    for fn, _wt, v in _fields(buf):
        if fn == 1:
            name = v.decode()
        elif fn == 2:  # TypeProto
            for fn2, _w2, v2 in _fields(v):
                if fn2 != 1:  # tensor_type
                    continue
                for fn3, _w3, v3 in _fields(v2):
                    if fn3 != 2:  # shape
                        continue
                    dims = []
                    for fn4, _w4, v4 in _fields(v3):
                        if fn4 != 1:  # dim
                            continue
                        dv = None
                        for fn5, _w5, v5 in _fields(v4):
                            if fn5 == 1:
                                dv = _signed(v5) if isinstance(v5, int) \
                                    else None
                        dims.append(dv)
    return name, dims


class OnnxGraph:
    def __init__(self, buf: bytes):
        self.nodes: List[_Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, Optional[List[int]]]] = []
        self.outputs: List[Tuple[str, Optional[List[int]]]] = []
        for fn, _wt, v in _fields(buf):
            if fn == 1:
                self.nodes.append(_Node(v))
            elif fn == 5:
                name, arr = _parse_tensor(v)
                self.initializers[name] = arr
            elif fn == 11:
                self.inputs.append(_parse_value_info(v))
            elif fn == 12:
                self.outputs.append(_parse_value_info(v))
        # graph "inputs" include initializers in some exporters
        self.inputs = [(n, s) for n, s in self.inputs
                       if n not in self.initializers]


def parse_model(data: bytes) -> OnnxGraph:
    """ModelProto: graph=7."""
    for fn, _wt, v in _fields(data):
        if fn == 7:
            return OnnxGraph(v)
    raise ValueError("no graph in ONNX model")




# ---------------------------------------------------------------------------
# values: host (CPU) or device tensors, with numpy's dtypes
# ---------------------------------------------------------------------------

_TORCH_OF = {np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16,
             np.dtype(np.uint16): torch.uint16,
             np.dtype(np.int32): torch.int32,
             np.dtype(np.uint32): torch.uint32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.uint64): torch.uint64,
             np.dtype(np.bool_): torch.bool}
_NUMPY_OF = {t: d for d, t in _TORCH_OF.items()}

# an initializer this small stays on the host (Resize scales, axes, small
# constants): host code reads it without a device sync
_HOST_MAX_NUMEL = 8


def _host_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _align(*ts) -> List[torch.Tensor]:
    """The tensors on one device: the first non-CPU one's, else the CPU."""
    dev = next((t.device for t in ts if t.device.type != "cpu"), None)
    if dev is None:
        return list(ts)
    return [t.to(dev, non_blocking=True) for t in ts]


def _np_dtype(fn, *ts):
    """torch dtype of numpy's `fn` on arrays of these tensors' dtypes."""
    probe = [np.ones(1, _NUMPY_OF[t.dtype]) for t in ts]
    return _TORCH_OF[np.asarray(fn(*probe)).dtype]


def _ints(t) -> List[int]:
    return [int(v) for v in _to_numpy(t).reshape(-1)]


def _erf_np(x):
    from scipy.special import erf
    return erf(x)


# ---------------------------------------------------------------------------
# op kernels
# ---------------------------------------------------------------------------


def _auto_pads(attrs, x_hw, k_hw, strides, dilations):
    """Resolve pads [t, l, b, r] honoring auto_pad."""
    ap = attrs.get("auto_pad", b"NOTSET")
    ap = ap.decode() if isinstance(ap, bytes) else ap
    if ap in ("NOTSET", ""):
        p = attrs.get("pads", [0] * 4)
        return list(p)
    if ap == "VALID":
        return [0, 0, 0, 0]
    # SAME_UPPER / SAME_LOWER
    pads = [0, 0, 0, 0]
    for ax in range(2):
        out = -(-x_hw[ax] // strides[ax])
        eff = dilations[ax] * (k_hw[ax] - 1) + 1
        total = max(0, (out - 1) * strides[ax] + eff - x_hw[ax])
        lo = total // 2 if ap == "SAME_UPPER" else -(-total // 2)
        pads[ax] = lo
        pads[ax + 2] = total - lo
    return pads


def _op_conv(node, vals):
    x = vals[node.inputs[0]]
    w = vals[node.inputs[1]]
    b = vals[node.inputs[2]] if len(node.inputs) > 2 else None
    if x.dim() != 4:
        raise NotImplementedError(f"Conv rank {x.dim()} (2-D only)")
    a = node.attrs
    sh, sw = a.get("strides", [1, 1])
    dh, dw = a.get("dilations", [1, 1])
    kh, kw = w.shape[2:]
    pt, pl, pb, pr = _auto_pads(a, x.shape[2:], (kh, kw), (sh, sw),
                                (dh, dw))
    ct = torch.promote_types(x.dtype, w.dtype)
    xd, w = _align(x, w)
    out = F.conv2d(F.pad(xd.to(ct), (pl, pr, pt, pb)), w.to(ct),
                   stride=(sh, sw), dilation=(dh, dw),
                   groups=a.get("group", 1))
    if b is not None:
        out = out + _align(out, b)[1][None, :, None, None]
    return out.to(x.dtype)


def _op_conv_transpose(node, vals):
    x = vals[node.inputs[0]]
    w = vals[node.inputs[1]]  # [C, M/g, kh, kw]
    b = vals[node.inputs[2]] if len(node.inputs) > 2 else None
    if x.dim() != 4:
        raise NotImplementedError("ConvTranspose 2-D only")
    a = node.attrs
    sh, sw = a.get("strides", [1, 1])
    dh, dw = a.get("dilations", [1, 1])
    opad = a.get("output_padding", [0, 0])
    pt, pl, pb, pr = a.get("pads", [0, 0, 0, 0])
    ct = torch.promote_types(x.dtype, w.dtype)
    xd, w = _align(x, w)
    # the full (uncropped) result, then the output padding's zero rows
    out = F.conv_transpose2d(xd.to(ct), w.to(ct), stride=(sh, sw),
                             dilation=(dh, dw), groups=a.get("group", 1))
    out = F.pad(out, (0, opad[1], 0, opad[0]))
    fh, fw = out.shape[2:]
    out = out[:, :, pt: fh - pb, pl: fw - pr]
    if b is not None:
        out = out + _align(out, b)[1][None, :, None, None]
    return out.to(x.dtype)


def _windows(x, kh, kw, sh, sw, dh, dw):
    """[N, C, H, W] -> windows [N, C, kh*kw, oh, ow]."""
    n, c, h, w = x.shape
    oh = (h - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w - (dw * (kw - 1) + 1)) // sw + 1
    cols = F.unfold(x, (kh, kw), dilation=(dh, dw), stride=(sh, sw))
    return cols.reshape(n, c, kh * kw, oh, ow)


def _op_pool(node, vals, is_max):
    x = vals[node.inputs[0]]
    a = node.attrs
    kh, kw = a.get("kernel_shape")
    sh, sw = a.get("strides", [1, 1])
    dh, dw = a.get("dilations", [1, 1])
    pt, pl, pb, pr = _auto_pads(a, x.shape[2:], (kh, kw), (sh, sw),
                                (dh, dw))
    if a.get("ceil_mode", 0):
        # extend bottom/right padding so the last partial window counts
        eff_h, eff_w = dh * (kh - 1) + 1, dw * (kw - 1) + 1
        oh = -(-(x.shape[2] + pt + pb - eff_h) // sh) + 1
        ow = -(-(x.shape[3] + pl + pr - eff_w) // sw) + 1
        pb = (oh - 1) * sh + eff_h - x.shape[2] - pt
        pr = (ow - 1) * sw + eff_w - x.shape[3] - pl
    pad = (pl, pr, pt, pb)
    cols = _windows(F.pad(x, pad, value=-math.inf if is_max else 0.0),
                    kh, kw, sh, sw, dh, dw)
    if is_max:
        return cols.amax(dim=2)
    if a.get("count_include_pad", 0):
        return cols.mean(dim=2)
    ones = F.pad(torch.ones_like(x, dtype=torch.float32), pad)
    cnt = _windows(ones, kh, kw, sh, sw, dh, dw)
    return cols.sum(dim=2) / cnt.sum(dim=2)


def _op_resize(node, vals):
    """Resize / Upsample in the numpy executor's coordinate modes
    (half_pixel, asymmetric, align_corners; nearest with its four
    rounding modes, else linear): source coordinates and weights in
    float64 on the host, the gathers and the blend on x's device."""
    x = vals[node.inputs[0]]
    a = node.attrs
    mode = a.get("mode", b"nearest")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    ct = a.get("coordinate_transformation_mode", b"half_pixel")
    ct = ct.decode() if isinstance(ct, bytes) else ct
    sizes = scales = None
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = _to_numpy(vals[node.inputs[3]])
    elif len(node.inputs) > 2 and node.inputs[2]:
        sc = _to_numpy(vals[node.inputs[2]])
        scales = sc if sc.size else None
    if sizes is None and scales is None:
        raise ValueError("Resize without scales/sizes")
    in_shape = np.asarray(x.shape)
    out_shape = (np.asarray(sizes, np.int64) if sizes is not None
                 else np.floor(in_shape * np.asarray(scales)).astype(
                     np.int64))
    if tuple(out_shape[:2]) != tuple(x.shape[:2]):
        raise NotImplementedError("Resize over N/C axes")

    def src_coords(odim, idim):
        o = np.arange(odim, dtype=np.float64)
        if idim == odim:
            return o
        scale = odim / idim
        if ct == "align_corners":
            return o * (idim - 1) / max(odim - 1, 1)
        if ct == "asymmetric":
            return o / scale
        return (o + 0.5) / scale - 0.5  # half_pixel

    ys = src_coords(int(out_shape[2]), x.shape[2])
    xs = src_coords(int(out_shape[3]), x.shape[3])
    dev = x.device

    def g(yy, xx):
        yy = torch.from_numpy(yy).to(dev, non_blocking=True)
        xx = torch.from_numpy(xx).to(dev, non_blocking=True)
        return x[:, :, yy[:, None], xx[None, :]]

    if mode == "nearest":
        nm = a.get("nearest_mode", b"round_prefer_floor")
        nm = nm.decode() if isinstance(nm, bytes) else nm
        if nm == "floor":
            yi, xi = np.floor(ys), np.floor(xs)
        elif nm == "ceil":
            yi, xi = np.ceil(ys), np.ceil(xs)
        elif nm == "round_prefer_ceil":
            yi, xi = np.floor(ys + 0.5), np.floor(xs + 0.5)
        else:  # round_prefer_floor
            yi, xi = np.ceil(ys - 0.5), np.ceil(xs - 0.5)
        yi = np.clip(yi, 0, x.shape[2] - 1).astype(np.int64)
        xi = np.clip(xi, 0, x.shape[3] - 1).astype(np.int64)
        return g(yi, xi)
    # linear
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, x.shape[2] - 1)
    y1 = np.clip(y0 + 1, 0, x.shape[2] - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, x.shape[3] - 1)
    x1 = np.clip(x0 + 1, 0, x.shape[3] - 1)
    wy = torch.from_numpy(np.clip(ys - y0, 0.0, 1.0)).to(
        dev, non_blocking=True)[None, None, :, None]
    wx = torch.from_numpy(np.clip(xs - x0, 0.0, 1.0)).to(
        dev, non_blocking=True)[None, None, None, :]
    out = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
           + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)
    return out.to(x.dtype)


def _op_slice(node, vals):
    x = vals[node.inputs[0]]
    if len(node.inputs) > 1:  # opset >= 10: inputs
        starts = _ints(vals[node.inputs[1]])
        ends = _ints(vals[node.inputs[2]])
        axes = (_ints(vals[node.inputs[3]])
                if len(node.inputs) > 3 and node.inputs[3]
                else list(range(len(starts))))
        steps = (_ints(vals[node.inputs[4]])
                 if len(node.inputs) > 4 and node.inputs[4]
                 else [1] * len(starts))
    else:  # opset 1: attributes
        starts = list(node.attrs["starts"])
        ends = list(node.attrs["ends"])
        axes = list(node.attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    int_max = np.iinfo(np.int32).max
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.dim()
        open_end = (sp > 0 and en >= int_max) or \
            (sp < 0 and en <= -int_max)
        sl = slice(st, None if open_end else en, sp)
        if sp > 0:
            x = x[(slice(None),) * ax + (sl,)]
        else:  # torch slices take no negative step: gather the indices
            idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
            x = x.index_select(ax, idx)
    return x


def _op_split(node, vals, n_out):
    x = vals[node.inputs[0]]
    ax = node.attrs.get("axis", 0)
    if len(node.inputs) > 1 and node.inputs[1]:
        sizes = _ints(vals[node.inputs[1]])
    elif "split" in node.attrs:
        sizes = list(node.attrs["split"])
    else:
        n = node.attrs.get("num_outputs", n_out)
        d = x.shape[ax]
        base = -(-d // n)
        sizes = [base] * (d // base) + ([d % base] if d % base else [])
    return list(torch.split(x, sizes, dim=ax))


def _op_pad(node, vals):
    x = vals[node.inputs[0]]
    if len(node.inputs) > 1:
        pads = _ints(vals[node.inputs[1]])
        cval = float(_to_numpy(vals[node.inputs[2]]).reshape(-1)[0]) \
            if len(node.inputs) > 2 and node.inputs[2] else 0.0
    else:
        pads = list(node.attrs["pads"])
        cval = node.attrs.get("value", 0.0)
    mode = node.attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    half = len(pads) // 2
    pw = list(zip(pads[:half], pads[half:]))
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return F.pad(x, flat, value=cval)
    np_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for ax, (lo, hi) in enumerate(pw):
        if lo or hi:  # np.pad's own index pattern along this axis
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = x.index_select(ax, torch.from_numpy(idx).to(x.device))
    return x


def _op_gemm(node, vals):
    a = vals[node.inputs[0]]
    b = vals[node.inputs[1]]
    at = node.attrs
    if at.get("transA", 0):
        a = a.T
    if at.get("transB", 0):
        b = b.T
    a, b = _align(a, b)
    ct = torch.promote_types(a.dtype, b.dtype)
    out = at.get("alpha", 1.0) * (a.to(ct) @ b.to(ct))
    if len(node.inputs) > 2:
        out, c = _align(out, vals[node.inputs[2]])
        out = out + at.get("beta", 1.0) * c
    return out


_REDUCE = {"ReduceMean": (np.mean, lambda x, d, k: x.mean(d, keepdim=k)),
           "ReduceSum": (np.sum, lambda x, d, k: x.sum(d, keepdim=k)),
           "ReduceMax": (np.max, lambda x, d, k: x.amax(d, keepdim=k)),
           "ReduceMin": (np.min, lambda x, d, k: x.amin(d, keepdim=k)),
           "ReduceProd": (np.prod, None),
           "ReduceL2": (lambda x: np.sqrt(np.sum(x * x)),
                        lambda x, d, k: (x * x).sum(d, keepdim=k).sqrt())}


def _op_reduce(node, vals):
    x = vals[node.inputs[0]]
    np_fn, fn = _REDUCE[node.op]
    if len(node.inputs) > 1 and node.inputs[1]:
        axes = tuple(_ints(vals[node.inputs[1]])) or None
    else:
        axes = node.attrs.get("axes")
        axes = tuple(axes) if axes is not None else None
    keep = bool(node.attrs.get("keepdims", 1))
    x = x.to(_np_dtype(np_fn, x))
    dims = tuple(range(x.dim())) if axes is None \
        else tuple(a % x.dim() for a in axes)
    if fn is not None:
        return fn(x, dims, keep)
    for d in sorted(dims, reverse=True):  # torch.prod takes one dim
        x = x.prod(d, keepdim=keep)
    return x


def _op_layer_norm(node, vals):
    x = vals[node.inputs[0]]
    w = _align(x, vals[node.inputs[1]])[1]
    ax = node.attrs.get("axis", -1)
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(ax % x.dim(), x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=axes, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps) * w
    if len(node.inputs) > 2:
        y = y + _align(y, vals[node.inputs[2]])[1]
    return y


def _op_batch_norm(node, vals):
    x, w, b, mean, var = _align(*(vals[n] for n in node.inputs[:5]))
    eps = node.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            * w.reshape(shape) + b.reshape(shape))


def _op_instance_norm(node, vals):
    x, w, b = _align(*(vals[n] for n in node.inputs[:3]))
    eps = node.attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mu = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mu) / torch.sqrt(var + eps) * w.reshape(shape) \
        + b.reshape(shape)


def _op_gather(node, vals):
    x, idx = _align(vals[node.inputs[0]], vals[node.inputs[1]].long())
    ax = node.attrs.get("axis", 0) % x.dim()
    n = x.shape[ax]
    flat = torch.where(idx < 0, idx + n, idx).reshape(-1)
    out = x.index_select(ax, flat)
    return out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])


def _op_argmax(node, vals):
    """The first index of the maximum (numpy's argmax)."""
    x = vals[node.inputs[0]]
    ax = node.attrs.get("axis", 0) % x.dim()
    n = x.shape[ax]
    pos = torch.arange(n, device=x.device).reshape(
        [n if d == ax else 1 for d in range(x.dim())])
    out = torch.where(x == x.amax(ax, keepdim=True), pos, n).amin(ax)
    return out.unsqueeze(ax) if node.attrs.get("keepdims", 1) else out


def _op_topk(node, vals):
    """numpy's argsort(kind='stable') of -x (largest) or x: ties keep
    their index order."""
    x = vals[node.inputs[0]]
    k = _ints(vals[node.inputs[1]])[0]
    ax = node.attrs.get("axis", -1) % x.dim()
    largest = node.attrs.get("largest", 1)
    idx = torch.sort(-x if largest else x, dim=ax, stable=True).indices
    idx = idx.narrow(ax, 0, k)
    return [torch.gather(x, ax, idx), idx.long()]


def _op_constant(node):
    a = node.attrs
    if "value" in a:
        return _host_tensor(a["value"])
    if "value_float" in a:
        return _host_tensor(np.float32(a["value_float"]))
    if "value_int" in a:
        return _host_tensor(np.int64(a["value_int"]))
    if "value_floats" in a:
        return _host_tensor(np.asarray(a["value_floats"], np.float32))
    if "value_ints" in a:
        return _host_tensor(np.asarray(a["value_ints"], np.int64))
    raise NotImplementedError("Constant variant")


def _op_clip(node, vals):
    """np.clip of x by its bounds (inputs, ONNX's type T like x, or the
    opset-6 attributes), in x's dtype."""
    x = vals[node.inputs[0]]
    lo, hi = (torch.as_tensor(
        vals[node.inputs[i]] if len(node.inputs) > i and node.inputs[i]
        else node.attrs.get(key, default), dtype=x.dtype, device=x.device)
        for i, key, default in ((1, "min", -math.inf),
                                (2, "max", math.inf)))
    return torch.clamp(x, min=lo, max=hi)


# elementwise ops as (the numpy executor's formula, the torch one): the
# numpy formula on one-element probes gives the result dtype; the torch
# formula runs on the inputs cast to it
_BINARY = {
    "Add": (np.add, torch.add), "Sub": (np.subtract, torch.sub),
    "Mul": (np.multiply, torch.mul), "Div": (np.divide, torch.div),
    "Pow": (np.power, torch.pow), "Min": (np.minimum, torch.minimum),
    "Max": (np.maximum, torch.maximum), "Mod": (np.fmod, torch.fmod),
}
_COMPARE = {
    "Equal": torch.eq, "Greater": torch.gt, "Less": torch.lt,
    "And": torch.logical_and, "Or": torch.logical_or,
}
_SQRT2 = np.sqrt(2.0)   # an np.float64: float32 inputs promote to float64
_UNARY = {
    "Relu": (lambda x: np.maximum(x, 0), lambda x: x.clamp_min(0)),
    "Sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)),
                lambda x: 1.0 / (1.0 + torch.exp(-x))),
    "Tanh": (np.tanh, torch.tanh), "Exp": (np.exp, torch.exp),
    "Log": (np.log, torch.log), "Sqrt": (np.sqrt, torch.sqrt),
    "Neg": (np.negative, torch.neg), "Abs": (np.abs, torch.abs),
    "Floor": (np.floor, torch.floor), "Ceil": (np.ceil, torch.ceil),
    "Erf": (_erf_np, torch.erf), "Not": (np.logical_not, torch.logical_not),
    "Identity": (lambda x: x, lambda x: x),
    "Softplus": (
        lambda x: np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0),
        lambda x: torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)),
    "HardSwish": (lambda x: x * np.clip(x / 6.0 + 0.5, 0.0, 1.0),
                  lambda x: x * (x / 6.0 + 0.5).clamp(0.0, 1.0)),
    "Mish": (
        lambda x: x * np.tanh(np.log1p(np.exp(-np.abs(x)))
                              + np.maximum(x, 0)),
        lambda x: x * torch.tanh(torch.log1p(torch.exp(-x.abs()))
                                 + x.clamp_min(0))),
    "Gelu": (lambda x: 0.5 * x * (1.0 + _erf_np(x / _SQRT2)),
             lambda x: 0.5 * x * (1.0 + torch.erf(x / float(_SQRT2)))),
    "LeakyRelu": None, "HardSigmoid": None,   # take attributes: below
}


class OnnxSession:
    """onnxruntime.InferenceSession-alike over the torch executor; the
    graph runs on `device` ("cuda" unless the caller asks for the CPU)."""

    def __init__(self, model_path_or_bytes, device="cuda"):
        if isinstance(model_path_or_bytes, (bytes, bytearray)):
            data = bytes(model_path_or_bytes)
        else:
            with open(model_path_or_bytes, "rb") as fh:
                data = fh.read()
        self.graph = parse_model(data)
        self.device = torch.device(device)
        self.initializers = {
            k: self._place(v) for k, v in self.graph.initializers.items()}

    def _place(self, arr: np.ndarray) -> torch.Tensor:
        """Floating arrays larger than a few values on the device, the
        rest (integers, bools, small constants) on the host."""
        t = _host_tensor(arr)
        if t.is_floating_point() and t.numel() > _HOST_MAX_NUMEL:
            return t.to(self.device)
        return t

    # -- ort-compatible introspection --------------------------------------
    class _IO:
        def __init__(self, name, shape):
            self.name = name
            self.shape = shape

    def get_inputs(self):
        return [self._IO(n, s) for n, s in self.graph.inputs]

    def get_outputs(self):
        return [self._IO(n, s) for n, s in self.graph.outputs]

    # -- execution ----------------------------------------------------------
    def run(self, output_names: Optional[Sequence[str]],
            feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Numpy feeds in, numpy outputs back (the ort contract)."""
        g = self.graph
        if not output_names:
            output_names = [n for n, _ in g.outputs]
        vals: Dict[str, torch.Tensor] = dict(self.initializers)
        for k, v in feeds.items():
            vals[k] = _host_tensor(np.asarray(v)).to(self.device)
        # last-use positions for memory reclamation
        last_use: Dict[str, int] = {}
        for idx, node in enumerate(g.nodes):
            for nm in node.inputs:
                if nm:
                    last_use[nm] = idx
        keep = set(output_names) | set(g.initializers)
        with torch.no_grad(), exact_fp32():
            for idx, node in enumerate(g.nodes):
                outs = _run_node(node, vals)
                for nm, arr in zip(node.outputs, outs):
                    if nm:
                        vals[nm] = arr
                for nm in node.inputs:
                    if nm and nm not in keep and last_use.get(nm) == idx:
                        vals.pop(nm, None)
        missing = [n for n in output_names if n not in vals]
        if missing:
            raise KeyError(f"outputs not produced: {missing}")
        return [_to_numpy(vals[n]) for n in output_names]


def _run_node(node: _Node, vals) -> List[torch.Tensor]:
    op = node.op
    ins = [vals[n] if n else None for n in node.inputs]
    if op in _BINARY:
        np_fn, fn = _BINARY[op]
        dt = _np_dtype(np_fn, ins[0], ins[1])
        a, b = _align(ins[0].to(dt), ins[1].to(dt))
        return [fn(a, b)]
    if op in _COMPARE:
        dt = torch.promote_types(ins[0].dtype, ins[1].dtype)
        a, b = _align(ins[0].to(dt), ins[1].to(dt))
        return [_COMPARE[op](a, b)]
    if _UNARY.get(op) is not None:
        np_fn, fn = _UNARY[op]
        return [fn(ins[0].to(_np_dtype(np_fn, ins[0])))]
    x = ins[0] if ins else None
    if op == "LeakyRelu":
        al = node.attrs.get("alpha", 0.01)
        return [torch.where(x >= 0, x, al * x)]
    if op == "HardSigmoid":
        al = node.attrs.get("alpha", 0.2)
        be = node.attrs.get("beta", 0.5)
        return [(al * x + be).clamp(0.0, 1.0)]
    if op == "Conv":
        return [_op_conv(node, vals)]
    if op == "ConvTranspose":
        return [_op_conv_transpose(node, vals)]
    if op == "MaxPool":
        return [_op_pool(node, vals, True)]
    if op == "AveragePool":
        return [_op_pool(node, vals, False)]
    if op == "GlobalAveragePool":
        return [x.mean(dim=(2, 3), keepdim=True)]
    if op == "MatMul":
        a, b = _align(*ins[:2])
        ct = torch.promote_types(a.dtype, b.dtype)
        return [a.to(ct) @ b.to(ct)]
    if op == "Gemm":
        return [_op_gemm(node, vals)]
    if op == "BatchNormalization":
        return [_op_batch_norm(node, vals)]
    if op == "LayerNormalization":
        return [_op_layer_norm(node, vals)]
    if op == "InstanceNormalization":
        return [_op_instance_norm(node, vals)]
    if op == "Softmax":
        ax = node.attrs.get("axis", -1)
        e = torch.exp(x - x.amax(dim=ax, keepdim=True))
        return [e / e.sum(dim=ax, keepdim=True)]
    if op == "Clip":
        return [_op_clip(node, vals)]
    if op == "Concat":
        dt = _np_dtype(lambda *a: np.concatenate(a), *ins)
        return [torch.cat(_align(*[t.to(dt) for t in ins]),
                          dim=node.attrs.get("axis", 0))]
    if op == "Split":
        return _op_split(node, vals, len(node.outputs))
    if op == "Slice":
        return [_op_slice(node, vals)]
    if op == "Reshape":
        shp = _ints(ins[1])
        shp = [x.shape[i] if (s == 0 and not node.attrs.get(
            "allowzero", 0)) else s for i, s in enumerate(shp)]
        return [x.reshape(shp)]
    if op == "Transpose":
        perm = node.attrs.get("perm", list(range(x.dim()))[::-1])
        return [x.permute(perm)]
    if op == "Flatten":
        ax = node.attrs.get("axis", 1) % (x.dim() + 1)
        return [x.reshape(math.prod(x.shape[:ax]), -1)]
    if op == "Shape":
        return [torch.tensor(list(x.shape), dtype=torch.int64)]
    if op == "Size":
        return [torch.tensor(x.numel(), dtype=torch.int64)]
    if op == "Gather":
        return [_op_gather(node, vals)]
    if op == "GatherElements":
        x, idx = _align(x, ins[1].long())
        ax = node.attrs.get("axis", 0) % x.dim()
        idx = torch.where(idx < 0, idx + x.shape[ax], idx)
        return [torch.gather(x, ax, idx)]
    if op == "Unsqueeze":
        axes = _ints(ins[1]) if len(ins) > 1 else node.attrs["axes"]
        for ax in sorted(a % (x.dim() + 1) for a in axes):
            x = x.unsqueeze(ax)
        return [x]
    if op == "Squeeze":
        if len(ins) > 1 and ins[1] is not None:
            axes = tuple(_ints(ins[1]))
        else:
            axes = node.attrs.get("axes")
            axes = tuple(axes) if axes else None
        return [x.squeeze() if axes is None
                else x.squeeze(tuple(a % x.dim() for a in axes))]
    if op == "Cast":
        return [x.to(_TORCH_OF[np.dtype(_DTYPES[node.attrs["to"]])])]
    if op == "Constant":
        return [_op_constant(node)]
    if op == "ConstantOfShape":
        v = node.attrs.get("value")
        v = v if v is not None else np.zeros(1, np.float32)
        return [_host_tensor(np.full(_ints(x), v.reshape(-1)[0], v.dtype))]
    if op == "Expand":
        shape = torch.broadcast_shapes(x.shape, tuple(_ints(ins[1])))
        return [x.expand(shape).contiguous()]
    if op == "Range":
        s, e, d = (_to_numpy(t).item() for t in ins)
        return [_host_tensor(np.arange(s, e, d))]
    if op == "Where":
        dt = _np_dtype(lambda a, b: np.where(True, a, b), ins[1], ins[2])
        c, a, b = _align(x.bool(), ins[1].to(dt), ins[2].to(dt))
        return [torch.where(c, a, b)]
    if op == "Tile":
        return [torch.tile(x, tuple(_ints(ins[1])))]
    if op in _REDUCE:
        return [_op_reduce(node, vals)]
    if op == "ArgMax":
        return [_op_argmax(node, vals)]
    if op == "TopK":
        return _op_topk(node, vals)
    if op == "Pad":
        return [_op_pad(node, vals)]
    if op in ("Resize", "Upsample"):
        return [_op_resize(node, vals)]
    if op == "Dropout":
        return [x]
    if op == "Einsum":
        eq = node.attrs["equation"]
        eq = eq.decode() if isinstance(eq, bytes) else eq
        return [torch.einsum(eq, *_align(*ins))]
    if op == "NonMaxSuppression":
        return [_host_tensor(_op_nms(node, vals))]
    raise NotImplementedError(
        f"ONNX op '{op}' not implemented (node '{node.name}')")


def _op_nms(node, vals):
    """NonMaxSuppression on the host: boxes [B, N, 4] (y1,x1,y2,x2 per
    center_point_box=0), scores [B, C, N] -> selected [K, 3] (batch,
    class, index)."""
    def arg(i):
        return _to_numpy(vals[node.inputs[i]]) \
            if len(node.inputs) > i and node.inputs[i] else None

    boxes, scores = arg(0), arg(1)
    max_out = int(arg(2).reshape(-1)[0]) if arg(2) is not None else 0
    iou_thr = float(arg(3).reshape(-1)[0]) if arg(3) is not None else 0.0
    score_thr = float(arg(4).reshape(-1)[0]) if arg(4) is not None \
        else -np.inf
    center = node.attrs.get("center_point_box", 0)
    sel = []
    for b in range(boxes.shape[0]):
        bb = boxes[b]
        if center:
            cx, cy, w, h = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
            bb = np.stack([cy - h / 2, cx - w / 2, cy + h / 2,
                           cx + w / 2], axis=1)
        for c in range(scores.shape[1]):
            keep = nms_indices(
                np.stack([bb[:, 1], bb[:, 0], bb[:, 3] - bb[:, 1],
                          bb[:, 2] - bb[:, 0]], axis=1),
                scores[b, c], score_thr, iou_thr)
            for i in keep[:max_out or None]:
                sel.append((b, c, i))
    return np.asarray(sel, np.int64).reshape(-1, 3)


def nms_indices(boxes_xywh: np.ndarray, scores: np.ndarray,
                score_threshold: float, iou_threshold: float
                ) -> List[int]:
    """Greedy NMS over [N, 4] xywh boxes; returns kept indices sorted by
    descending score (the cv2.dnn.NMSBoxes contract the reference's YOLO
    postprocess relies on, pose2d.py:192)."""
    boxes_xywh = np.asarray(boxes_xywh, np.float64)
    scores = np.asarray(scores, np.float64)
    valid = np.flatnonzero(scores >= score_threshold)
    order = valid[np.argsort(-scores[valid], kind="stable")]
    x, y, w, h = (boxes_xywh[:, i] for i in range(4))
    x2, y2 = x + w, y + h
    area = np.maximum(w, 0) * np.maximum(h, 0)
    keep: List[int] = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x[i], x[order])
        yy1 = np.maximum(y[i], y[order])
        xx2 = np.minimum(x2[i], x2[order])
        yy2 = np.minimum(y2[i], y2[order])
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        union = area[i] + area[order] - inter
        iou = np.where(union > 0, inter / union, 0.0)
        suppressed[order[iou > iou_threshold]] = True
        suppressed[i] = False
    return keep
