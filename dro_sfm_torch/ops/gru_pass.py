"""One fused separable-ConvGRU pass and its gradient: kernels K5 (forward),
K6-input and K6-weight (backward), each with its plain version.

PyTorch counterpart of `dro_sfm_tpu/ops/pallas/gru_pass.py:gru_sep1d_pass`,
with its layout at the public function: h [B,H,W,D] and x [B,H,W,Cx]
channel-minor, weights [5, D+Cx, out] (z first, then r, in ``wzr``), axis 2
for the (1,5) pass along W and 1 for the (5,1) pass along H::

    zr = sigmoid(conv5([h, x], wzr) + bzr)
    q  = tanh(conv5([r*h, x], wq) + bq)
    h' = (1 - z) * h + z * q

On CUDA tensors `gru_sep1d_pass` launches the hand-written Hopper kernels
(`csrc/gru_pass_fwd.cu`, `csrc/gru_pass_bwd.cu`) or raises; on CPU tensors it
runs `gru_pass_plain` and `gru_pass_bwd_plain`. Both follow the Pallas
kernel's rounding points (`_recompute`, `_grad_intermediates`): the compute
dtype is bf16 for bf16 inputs, else fp32; the convs multiply compute-dtype
operands and sum in fp32, the bias is added in fp32, sigmoid and tanh run on
the fp32 sums and are rounded to the compute dtype, r*h and the update are
formed in the compute dtype; in the backward daq and dazr are rounded to the
compute dtype before the transposed convs and the weight products, and the
weight and bias gradients come back in fp32. This is not the arithmetic of
`SepConvGRU`'s ``split`` path, which rounds the conv output before the
sigmoid in bf16.

Weights enter in fp32 (the parameters) and are cast inside, as `_run_fwd` and
`_run_bwd` cast them, so their gradients reach the fp32 parameters unrounded.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dro_sfm_torch.kernels import LaunchCounter, entry, launch, on_device

K_TAPS = 5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

K5_COUNTER = LaunchCounter()
K6I_COUNTER = LaunchCounter()
K6W_COUNTER = LaunchCounter()


def _compute_dtype(dtype):
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _shift_last(v, axis):
    """[B,H,W,C] -> [B,R,S,C] with S the shift axis (a view)."""
    return v if axis == 2 else v.transpose(1, 2)


def _taps(v):
    """The five tap-shifted views of v [B,R,S,C] along S, zero padded: tap
    k at s reads v[s + k - 2]."""
    s = v.shape[2]
    vp = F.pad(v, (0, 0, 2, 2))
    return [vp[:, :, k:k + s] for k in range(K_TAPS)]


def _conv(v, w, bias=None):
    """sum_k v[s + k - 2] @ w[k] in fp32 (+ bias in fp32): v [B,R,S,Cin] and
    w [5,Cin,O] in the compute dtype, whose products are exact in fp32."""
    acc = None
    for k, vk in enumerate(_taps(v.float())):
        y = vk @ w[k].float()
        acc = y if acc is None else acc + y
    return acc if bias is None else acc + bias.float()


def _conv_t(d, w):
    """The transposed (input-gradient) conv in fp32:
    sum_k d[s + k - 2] @ w[4 - k]^T, d [B,R,S,O], w [5,Cin,O]."""
    acc = None
    for k, dk in enumerate(_taps(d.float())):
        y = dk @ w[K_TAPS - 1 - k].float().t()
        acc = y if acc is None else acc + y
    return acc


def _conv_w(v, d):
    """Weight gradient [5, Cin, O] in fp32: sum over pixels of
    v[s + k - 2]^T d[s]."""
    cin, o = v.shape[-1], d.shape[-1]
    df = d.float().reshape(-1, o)
    return torch.stack([vk.reshape(-1, cin).t() @ df for vk in _taps(v.float())])


def _recompute(h, x, wzr, bzr, wq, bq):
    """The pass on h, x [B,R,S,*] and weights in the compute dtype: returns
    hx, z, r, rhx, q, h' (all but hx, rhx [B,R,S,D])."""
    d = h.shape[-1]
    hx = torch.cat([h, x], dim=-1)
    zr = torch.sigmoid(_conv(hx, wzr, bzr)).to(h.dtype)
    z, r = zr[..., :d], zr[..., d:]
    rhx = torch.cat([r * h, x], dim=-1)
    q = torch.tanh(_conv(rhx, wq, bq)).to(h.dtype)
    return hx, z, r, rhx, q, (1.0 - z) * h + z * q


def gru_pass_plain(h, x, wzr, bzr, wq, bq, axis: int) -> torch.Tensor:
    """K5's plain version: one pass, in h's dtype, contiguous [B,H,W,D]."""
    cdt = _compute_dtype(h.dtype)
    hs, xs = _shift_last(h, axis).to(cdt), _shift_last(x, axis).to(cdt)
    out = _recompute(hs, xs, wzr.to(cdt), bzr, wq.to(cdt), bq)[-1]
    return _shift_last(out, axis).to(h.dtype).contiguous()


def gru_pass_bwd_plain(h, x, wzr, bzr, wq, bq, g, axis: int):
    """K6's plain version: (dh, dx, dwzr, dbzr, dwq, dbq) for cotangent g of
    the pass; dh, dx in h's and x's dtype, the rest fp32."""
    cdt = _compute_dtype(h.dtype)
    hs, xs = _shift_last(h, axis).to(cdt), _shift_last(x, axis).to(cdt)
    wzr_c, wq_c = wzr.to(cdt), wq.to(cdt)
    d = hs.shape[-1]
    hx, z, r, rhx, q, _ = _recompute(hs, xs, wzr_c, bzr, wq_c, bq)
    gf = _shift_last(g, axis).float()
    qf, zf, hf, rf = q.float(), z.float(), hs.float(), r.float()
    dz = gf * (qf - hf)
    daq_f = (gf * zf) * (1.0 - qf * qf)
    daq = daq_f.to(cdt)
    dh0 = gf * (1.0 - zf)
    drhx = _conv_t(daq, wq_c)
    drh, dxq = drhx[..., :d], drhx[..., d:]
    dr = drh * hf
    dazr_f = torch.cat([dz * zf * (1.0 - zf), dr * rf * (1.0 - rf)], dim=-1)
    dazr = dazr_f.to(cdt)
    dhx = _conv_t(dazr, wzr_c)
    dh = dh0 + drh * rf + dhx[..., :d]
    dx = dxq + dhx[..., d:]
    return (_shift_last(dh, axis).to(h.dtype).contiguous(),
            _shift_last(dx, axis).to(x.dtype).contiguous(),
            _conv_w(hx, dazr), dazr_f.sum((0, 1, 2)),
            _conv_w(rhx, daq), daq_f.sum((0, 1, 2)))


def _round16(n):
    return -(-n // 16) * 16


def _padded_weight(w, d, cx, groups, cdt):
    """[5, d+cx, groups*d] fp32 -> [5, Dp+Cxp, groups*Dp] in ``cdt``,
    contiguous: h's channels in rows [0, Dp), x's in [Dp, Dp+Cxp), each
    output group in its Dp columns, zeros where padded. Without padding it
    is the one cast-and-copy of the weight."""
    dp, cxp = _round16(d), _round16(cx)
    if (dp, cxp) == (d, cx):
        # `to` returns a permuted fp32 view as it is: contiguous() copies it
        return w.to(cdt).contiguous()
    out = torch.zeros(K_TAPS, dp + cxp, groups * dp, dtype=cdt, device=w.device)
    for i in range(groups):
        cols = slice(i * dp, i * dp + d)
        out[:, :d, cols] = w[:, :d, i * d:(i + 1) * d]
        out[:, dp:dp + cx, cols] = w[:, d:, i * d:(i + 1) * d]
    return out


def _padded_bias(b, d, groups):
    dp = _round16(d)
    if dp == d:
        return b.float().contiguous()
    out = torch.zeros(groups * dp, dtype=torch.float32, device=b.device)
    for i in range(groups):
        out[i * dp:i * dp + d] = b[i * d:(i + 1) * d]
    return out


def _unpad_weight(w, d, cx, groups):
    """The inverse of `_padded_weight`'s layout, fp32."""
    dp = _round16(d)
    if dp == d and w.shape[1] == d + cx:
        return w
    rows = torch.cat([torch.arange(d), dp + torch.arange(cx)]).to(w.device)
    cols = torch.cat([i * dp + torch.arange(d) for i in range(groups)]).to(w.device)
    return w[:, rows][:, :, cols]


def _unpad_bias(b, d, groups):
    dp = _round16(d)
    if dp == d:
        return b
    return torch.cat([b[i * dp:i * dp + d] for i in range(groups)])


class _Prepared:
    """The kernels' operands of one call: h, x in the compute dtype,
    weights and biases padded (`_padded_weight`), the sizes and flags."""

    def __init__(self, h, x, wzr, bzr, wq, bq):
        cdt = _compute_dtype(h.dtype)
        self.h = h.to(cdt).contiguous()
        self.x = x.to(cdt).contiguous()
        b, hh, ww, d = h.shape
        cx = x.shape[-1]
        self.sizes = (b, hh, ww, d, cx, _round16(d), _round16(cx))
        self.wzr = _padded_weight(wzr, d, cx, 2, cdt)
        self.wq = _padded_weight(wq, d, cx, 1, cdt)
        self.bzr, self.bq = _padded_bias(bzr, d, 2), _padded_bias(bq, d, 1)
        for name, t in (("wzr", self.wzr), ("wq", self.wq)):
            if t.data_ptr() % 32:
                raise ValueError(f"gru_sep1d_pass kernel wants a 32-byte aligned {name}")
        vec = 16 // self.h.element_size()
        self.vec = int(d % vec == 0 and cx % vec == 0 and self.h.data_ptr() % 16 == 0
                       and self.x.data_ptr() % 16 == 0)
        self.dtype = cdt
        self.code = _DTYPE_CODE[cdt]


def _launch_k5(p: _Prepared, axis):
    fn = entry("gru_pass_fwd", "gru_pass_fwd",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    out = torch.empty_like(p.h)
    launch(fn, p.h.device, p.h.data_ptr(), p.x.data_ptr(), p.wzr.data_ptr(),
           p.bzr.data_ptr(), p.wq.data_ptr(), p.bq.data_ptr(), out.data_ptr(), *p.sizes,
           axis, p.code, p.vec)
    K5_COUNTER.launches += 1
    return out


def _launch_k6_input(p: _Prepared, g, axis):
    """K6-input: (dh, dx, scratch) with scratch = (r*h, T(daq), T(dazr) in
    the compute dtype at padded widths, per-block fp32 bias sums, their row
    count), which K6-weight reads."""
    b, hh, ww, d, cx, dp, cxp = p.sizes
    blocks_fn = entry("gru_pass_bwd", "gru_pass_bwd_blocks", [ctypes.c_int] * 7)
    blocks_fn.restype = ctypes.c_longlong
    n_part = blocks_fn(b, hh, ww, dp, cxp, axis, p.code)
    if n_part < 0:
        raise ValueError(f"gru_sep1d_pass backward: D={d}, Cx={cx} too wide for the "
                         "kernel's shared memory")
    g = g.to(p.dtype).contiguous()
    dev, cdt = p.h.device, p.dtype
    dh, dx = torch.empty_like(p.h), torch.empty_like(p.x)
    rh_s = torch.empty((b, hh, ww, dp), dtype=cdt, device=dev)
    daq_s = torch.empty((b, hh, ww, dp), dtype=cdt, device=dev)
    dazr_s = torch.empty((b, hh, ww, 2 * dp), dtype=cdt, device=dev)
    part = torch.empty((max(n_part, 1), 3 * dp), dtype=torch.float32, device=dev)
    fn = entry("gru_pass_bwd", "gru_pass_bwd_input",
               [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    launch(fn, dev, p.h.data_ptr(), p.x.data_ptr(), p.wzr.data_ptr(), p.bzr.data_ptr(),
           p.wq.data_ptr(), p.bq.data_ptr(), g.data_ptr(), dh.data_ptr(), dx.data_ptr(),
           rh_s.data_ptr(), daq_s.data_ptr(), dazr_s.data_ptr(), part.data_ptr(), *p.sizes,
           axis, p.code, p.vec)
    K6I_COUNTER.launches += 1
    return dh, dx, (rh_s, daq_s, dazr_s, part, n_part)


def _launch_k6_weight(p: _Prepared, scratch, axis):
    """K6-weight: (dwzr, dbzr, dwq, dbq) fp32 from K6-input's scratch."""
    rh_s, daq_s, dazr_s, part, n_part = scratch
    b, hh, ww, d, cx, dp, cxp = p.sizes
    dev, c1p = p.h.device, dp + cxp
    dwzr = torch.empty((K_TAPS, c1p, 2 * dp), dtype=torch.float32, device=dev)
    dwq = torch.empty((K_TAPS, c1p, dp), dtype=torch.float32, device=dev)
    dbzr = torch.empty(2 * dp, dtype=torch.float32, device=dev)
    dbq = torch.empty(dp, dtype=torch.float32, device=dev)
    fn = entry("gru_pass_bwd", "gru_pass_bwd_weight",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    launch(fn, dev, p.h.data_ptr(), p.x.data_ptr(), rh_s.data_ptr(), daq_s.data_ptr(),
           dazr_s.data_ptr(), part.data_ptr(), n_part, dwzr.data_ptr(), dbzr.data_ptr(),
           dwq.data_ptr(), dbq.data_ptr(), *p.sizes, axis, p.code, p.vec)
    K6W_COUNTER.launches += 1
    return (_unpad_weight(dwzr, d, cx, 2), _unpad_bias(dbzr, d, 2),
            _unpad_weight(dwq, d, cx, 1), _unpad_bias(dbq, d, 1))


def _launch_k6(p: _Prepared, g, axis):
    dh, dx, scratch = _launch_k6_input(p, g, axis)
    return (dh, dx, *_launch_k6_weight(p, scratch, axis))


def gru_pass_fwd(h, x, wzr, bzr, wq, bq, axis: int) -> torch.Tensor:
    """The pass: kernel K5 for CUDA tensors, `gru_pass_plain` for CPU
    tensors."""
    return on_device("gru_sep1d_pass", h.device,
                     lambda: _launch_k5(_Prepared(h, x, wzr, bzr, wq, bq), axis),
                     lambda: gru_pass_plain(h, x, wzr, bzr, wq, bq, axis))


def gru_pass_bwd(h, x, wzr, bzr, wq, bq, g, axis: int):
    """The pass's gradient (dh, dx, dwzr, dbzr, dwq, dbq): kernels K6-input
    and K6-weight for CUDA tensors, `gru_pass_bwd_plain` for CPU tensors."""
    return on_device("gru_sep1d_pass backward", h.device,
                     lambda: _launch_k6(_Prepared(h, x, wzr, bzr, wq, bq), g, axis),
                     lambda: gru_pass_bwd_plain(h, x, wzr, bzr, wq, bq, g, axis))


class _GruPass(torch.autograd.Function):
    """`gru_sep1d_pass` with the backward of `_pass_bwd`: K6 recomputes the
    pass from the saved inputs (no gate activation is kept); the weight and
    bias gradients come back in fp32."""

    @staticmethod
    def forward(ctx, h, x, wzr, bzr, wq, bq, axis):
        ctx.axis = axis
        ctx.save_for_backward(h, x, wzr, bzr, wq, bq)
        return gru_pass_fwd(h, x, wzr, bzr, wq, bq, axis)

    @staticmethod
    def backward(ctx, g):
        h, x, wzr, bzr, wq, bq = ctx.saved_tensors
        dh, dx, dwzr, dbzr, dwq, dbq = gru_pass_bwd(h, x, wzr, bzr, wq, bq, g, ctx.axis)
        return (dh, dx, dwzr.to(wzr.dtype), dbzr.to(bzr.dtype), dwq.to(wq.dtype),
                dbq.to(bq.dtype), None)


def _check(h, x, wzr, bzr, wq, bq, axis):
    if axis not in (1, 2):
        raise ValueError(f"gru_sep1d_pass axis {axis}: want 1 (the (5,1) pass) or 2")
    if h.ndim != 4 or x.ndim != 4 or h.shape[:3] != x.shape[:3]:
        raise ValueError(f"gru_sep1d_pass wants h [B,H,W,D] and x [B,H,W,Cx]; got "
                         f"{tuple(h.shape)}, {tuple(x.shape)}")
    d, c1 = h.shape[-1], h.shape[-1] + x.shape[-1]
    want = {"wzr": (K_TAPS, c1, 2 * d), "bzr": (2 * d,), "wq": (K_TAPS, c1, d), "bq": (d,)}
    for name, t in (("wzr", wzr), ("bzr", bzr), ("wq", wq), ("bq", bq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"gru_sep1d_pass {name} {tuple(t.shape)}, want {want[name]}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"gru_sep1d_pass wants fp32 or bf16 h; got {h.dtype}")
    devices = {t.device for t in (h, x, wzr, bzr, wq, bq)}
    if len(devices) != 1:
        raise ValueError(f"gru_sep1d_pass inputs on several devices: {devices}")


def gru_sep1d_pass(h: torch.Tensor, x: torch.Tensor, wzr: torch.Tensor,
                   bzr: torch.Tensor, wq: torch.Tensor, bq: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """One directional SepConvGRU pass, fused; differentiable in every
    tensor.

    h [B,H,W,D] hidden state; x [B,H,W,Cx] input features; wzr [5,D+Cx,2D]
    (z first) and wq [5,D+Cx,D], fp32 (cast inside); bzr [2D], bq [D];
    ``axis`` 2 for the (1,5) pass, 1 for the (5,1) pass. Returns h' [B,H,W,D]
    contiguous in h's dtype. CUDA tensors go to kernel K5 (backward K6-input
    and K6-weight), CPU tensors to the plain versions.
    """
    _check(h, x, wzr, bzr, wq, bq, axis)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, x, wzr, bzr, wq, bq)):
        return _GruPass.apply(h, x, wzr, bzr, wq, bq, axis)
    return gru_pass_fwd(h, x, wzr, bzr, wq, bq, axis)
