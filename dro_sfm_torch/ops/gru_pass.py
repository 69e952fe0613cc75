"""One fused separable-ConvGRU pass and its gradient: kernels K5 (forward),
K6-input and K6-weight (backward), each with its plain version.

PyTorch counterpart of `dro_sfm_tpu/ops/pallas/gru_pass.py:gru_sep1d_pass`,
with its layout at the public function: h [B,H,W,D] and x [B,H,W,Cx]
channel-minor, weights [5, D+Cx, out] (z first, then r, in ``wzr``), axis 2
for the (1,5) pass along W and 1 for the (5,1) pass along H::

    zr = sigmoid(conv5([h, x], wzr) + bzr)
    q  = tanh(conv5([r*h, x], wq) + bq)
    h' = (1 - z) * h + z * q

`gru_sep1d_pass` runs the `torch.library` operator
``dro_sfm::gru_sep1d_pass``, so that a trace (`torch.export`) keeps it. On
CUDA tensors it launches the hand-written Hopper kernels
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
import ctypes
import functools

import torch
import torch.nn.functional as F

from dro_sfm_torch.kernels import LaunchCounter, entry, launch, on_device, sm_count

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
        self.vec = (d % vec == 0 and cx % vec == 0 and self.h.data_ptr() % 16 == 0
                    and self.x.data_ptr() % 16 == 0)
        self.dtype = cdt
        self.code = _DTYPE_CODE[cdt]

    def chunked(self, g=None):
        """(h, x, g, D, Cx) as the kernels read them: whole 16-byte chunks
        of a pixel's channels, 16-byte aligned. Where D or Cx is not a
        multiple of 16 bytes, h, x and g go in zero padded to Dp and Cxp
        (D and Cx then name the padded widths), and the caller cuts its
        outputs."""
        if self.vec:
            return self.h, self.x, g, self.sizes[3], self.sizes[4]
        d, cx, dp, cxp = self.sizes[3:]
        return (F.pad(self.h, (0, dp - d)), F.pad(self.x, (0, cxp - cx)),
                None if g is None else F.pad(g, (0, dp - d)), dp, cxp)


# The tiles of K5 and K6 (`csrc/gru_gemm.cuh`, `csrc/gru_conv.cuh`). All walk
# the pixels line by line along the shift axis in segments of 8, 16 or 32
# positions (`gru_segment`). K5's two launches and K6-input's four are grids
# of row tiles of GRU_BM pixels of whole segments x GRU_BN columns;
# K6-weight's blocks K6W_CH channels x K6W_OUT outputs for all five taps,
# over stages of K6W_PIX pixels. K6-weight splits the stages (split-K) into
# as many ranges as the grid holds _K6W_BLOCKS_PER_SM blocks an SM in one
# wave, each at least _K6W_MIN_STEPS stages.
GRU_BM, GRU_BN = 128, 64
K6W_CH, K6W_OUT, K6W_PIX = 64, 64, 32
_K6W_MIN_STEPS, _K6W_BLOCKS_PER_SM = 8, 2


def gru_segment(s: int) -> int:
    """The segment of K5 and K6 for lines of ``s`` positions: of 32, 16 and
    8 the one that leaves the fewest positions empty, the longest of
    those."""
    return min((32, 16, 8), key=lambda seg: (-(-s // seg) * seg - s, -seg))


def gru_row_tiles(b: int, hh: int, ww: int, axis: int) -> int:
    """The row tiles of K5's launches and K6-input's: GRU_BM rows of whole
    segments each (so rows of K6-input's bias sums)."""
    s = ww if axis == 2 else hh
    seg = gru_segment(s)
    return -(-(b * hh * ww // s * -(-s // seg)) // (GRU_BM // seg))


def _launch_k5(p: _Prepared, axis):
    """K5: two CUDA launches (the gate conv, then the candidate conv with
    the update in its epilogue); z and r*h go through a transient scratch.
    The kernel refuses a plan of row tiles other than its own."""
    b, hh, ww, d, cx, dp, cxp = p.sizes
    h, x, _, dk, cxk = p.chunked()
    dev = p.h.device
    out = torch.empty((b, hh, ww, dk), dtype=p.dtype, device=dev)
    scratch = torch.empty((2, b * hh * ww, dp), dtype=p.dtype, device=dev)   # z, r*h
    fn = entry("gru_pass_fwd", "gru_pass_fwd",
               [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    launch(fn, dev, *(t.data_ptr() for t in (h, x, p.wzr, p.bzr, p.wq, p.bq, out,
                                              scratch[0], scratch[1])),
           gru_row_tiles(b, hh, ww, axis), b, hh, ww, dk, cxk, dp, cxp, axis,
           gru_segment(ww if axis == 2 else hh).bit_length() - 1, p.code)
    K5_COUNTER.launches += 1
    return out if dk == d else out[..., :d].contiguous()


def k6_weight_plan(b: int, hh: int, ww: int, axis: int, dp: int, cxp: int, sms: int):
    """K6-weight's launch plan on a card with ``sms`` SMs: (segment length,
    number of splits, stages a split)."""
    s = ww if axis == 2 else hh
    seg = gru_segment(s)
    steps = -(-(b * hh * ww // s) * -(-s // seg) // (K6W_PIX // seg))
    tiles = -(-(dp + cxp) // K6W_CH) * (-(-2 * dp // K6W_OUT) + -(-dp // K6W_OUT))
    want = _K6W_BLOCKS_PER_SM * sms // tiles
    per = -(-steps // max(1, min(want, steps // _K6W_MIN_STEPS)))
    return seg, -(-steps // per), per


def k6_split_pixels(b: int, hh: int, ww: int, axis: int, seg: int, n_split: int, per: int):
    """The pixels (b H W + i W + j) each of K6-weight's splits sums over, in
    split order and in the order the split walks them: line by line along
    the shift axis, segment by segment."""
    s, ss = (ww, 1) if axis == 2 else (hh, ww)
    spl = -(-s // seg)
    n_segs = b * hh * ww // s * spl
    out = []
    for y in range(n_split):
        pix = []
        for g in range(y * per * (K6W_PIX // seg), min((y + 1) * per * (K6W_PIX // seg), n_segs)):
            line, s0 = g // spl, g % spl * seg
            base = line // ss * s * ss + line % ss
            pix += [base + p * ss for p in range(s0, min(s0 + seg, s))]
        out.append(pix)
    return out


@functools.lru_cache(maxsize=None)
def _check_gru_tiles() -> None:
    fn = entry("gru_pass_bwd", "gru_pass_bwd_tile", [ctypes.c_int])
    want = (GRU_BM, GRU_BN, K6W_CH, K6W_OUT, K6W_PIX)
    got = tuple(fn(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"gru_pass_bwd tiles {got}, the wrapper plans for {want}")


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (a copy if need be)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_k6_input(p: _Prepared, g, axis):
    """K6-input: (dh, dx, scratch), dh and dx cut to D and Cx where the
    operands went in padded (`_Prepared.chunked`). scratch = (h, x as the
    kernels read them, their widths, r*h, T(daq), T(dazr) in the compute
    dtype at padded widths, the fp32 bias sums of each GRU_BM-pixel tile),
    which K6-weight reads."""
    _check_gru_tiles()
    b, hh, ww, d, cx, dp, cxp = p.sizes
    h, x, g, dk, cxk = p.chunked(_aligned(g.to(p.dtype)))
    n = b * hh * ww
    seg = gru_segment(ww if axis == 2 else hh)
    dev, cdt = p.h.device, p.dtype
    dh = torch.empty((b, hh, ww, dk), dtype=cdt, device=dev)
    dx = torch.empty((b, hh, ww, cxk), dtype=cdt, device=dev)
    zr_s = torch.empty((n, 2 * dp), dtype=cdt, device=dev)
    rh_s = torch.empty((n, dp), dtype=cdt, device=dev)
    daq_s = torch.empty((n, dp), dtype=cdt, device=dev)
    dazr_s = torch.empty((n, 2 * dp), dtype=cdt, device=dev)
    dhp_s = torch.empty((n, dp), dtype=torch.float32, device=dev)
    part = torch.empty((gru_row_tiles(b, hh, ww, axis), 3 * dp), dtype=torch.float32,
                       device=dev)
    fn = entry("gru_pass_bwd", "gru_pass_bwd_input",
               [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    launch(fn, dev, *(t.data_ptr() for t in (h, x, p.wzr, p.bzr, p.wq, p.bq, g, dh, dx,
                                              zr_s, rh_s, daq_s, dazr_s, dhp_s, part)),
           b, hh, ww, dk, cxk, dp, cxp, axis, seg.bit_length() - 1, p.code)
    K6I_COUNTER.launches += 1
    if dk != d or cxk != cx:
        dh, dx = dh[..., :d].contiguous(), dx[..., :cx].contiguous()
    return dh, dx, (h, x, dk, cxk, rh_s, daq_s, dazr_s, part)


def _launch_k6_weight(p: _Prepared, scratch, axis):
    """K6-weight: (dwzr, dbzr, dwq, dbq) fp32 from K6-input's scratch."""
    h, x, dk, cxk, rh_s, daq_s, dazr_s, part = scratch
    b, hh, ww, d, cx, dp, cxp = p.sizes
    dev, c1p = p.h.device, dp + cxp
    seg, n_split, per = k6_weight_plan(b, hh, ww, axis, dp, cxp, sm_count(dev.index or 0))
    m = K_TAPS * c1p
    n_w = m * 3 * dp
    partials = torch.empty((n_split, n_w), dtype=torch.float32, device=dev)
    out = torch.empty(n_w + 3 * dp, dtype=torch.float32, device=dev)
    fn = entry("gru_pass_bwd", "gru_pass_bwd_weight",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    launch(fn, dev, h.data_ptr(), x.data_ptr(), rh_s.data_ptr(), daq_s.data_ptr(),
           dazr_s.data_ptr(), part.data_ptr(), part.shape[0], partials.data_ptr(),
           out.data_ptr(), n_split, per, b, hh, ww, dk, cxk, dp, cxp, axis,
           seg.bit_length() - 1, p.code)
    K6W_COUNTER.launches += 1
    dwzr = out[:m * 2 * dp].view(K_TAPS, c1p, 2 * dp)
    dwq = out[m * 2 * dp:n_w].view(K_TAPS, c1p, dp)
    dbzr, dbq = out[n_w:n_w + 2 * dp], out[n_w + 2 * dp:]
    return (_unpad_weight(dwzr, d, cx, 2), _unpad_bias(dbzr, d, 2),
            _unpad_weight(dwq, d, cx, 1), _unpad_bias(dbq, d, 1))


def _launch_k6(p: _Prepared, g, axis):
    dh, dx, scratch = _launch_k6_input(p, g, axis)
    return (dh, dx, *_launch_k6_weight(p, scratch, axis))


def gru_pass_fwd(h, x, wzr, bzr, wq, bq, axis: int) -> torch.Tensor:
    """Kernel K5 on CUDA tensors: the CUDA implementation of the operator
    ``dro_sfm::gru_sep1d_pass``, which looks it up here at every call. Its
    host-side plan (the padded weights of `_Prepared`, the row tiles) is
    made here, at run time, for the card the tensors are on."""
    if h.device.type != "cuda":
        raise ValueError(f"kernel K5 wants CUDA tensors; got {h.device}")
    return _launch_k5(_Prepared(h, x, wzr, bzr, wq, bq), axis)


def gru_pass_bwd(h, x, wzr, bzr, wq, bq, g, axis: int):
    """The pass's gradient (dh, dx, dwzr, dbzr, dwq, dbq): kernels K6-input
    and K6-weight for CUDA tensors, `gru_pass_bwd_plain` for CPU tensors."""
    return on_device("gru_sep1d_pass backward", h.device,
                     lambda: _launch_k6(_Prepared(h, x, wzr, bzr, wq, bq), g, axis),
                     lambda: gru_pass_bwd_plain(h, x, wzr, bzr, wq, bq, g, axis))


# K5 as the operator dro_sfm::gru_sep1d_pass: the dispatcher picks the kernel
# for CUDA tensors and the plain version for CPU tensors, and a trace
# (torch.export) records the operator itself. The backward, registered with
# it, recomputes the pass from the saved inputs in K6 (no gate activation is
# kept); the weight and bias gradients come back in fp32 and are cast to the
# parameters' dtypes.
@torch.library.custom_op("dro_sfm::gru_sep1d_pass", mutates_args=())
def _gru_pass_op(h: torch.Tensor, x: torch.Tensor, wzr: torch.Tensor, bzr: torch.Tensor,
                 wq: torch.Tensor, bq: torch.Tensor, axis: int) -> torch.Tensor:
    raise ValueError(f"gru_sep1d_pass has no path for device {h.device}")


@_gru_pass_op.register_kernel("cuda")
def _gru_pass_cuda(h, x, wzr, bzr, wq, bq, axis):
    return gru_pass_fwd(h, x, wzr, bzr, wq, bq, axis)


_gru_pass_op.register_kernel("cpu")(gru_pass_plain)


@_gru_pass_op.register_fake
def _gru_pass_fake(h, x, wzr, bzr, wq, bq, axis):
    return h.new_empty(h.shape)


def _gru_pass_setup(ctx, inputs, output):
    *tensors, ctx.axis = inputs
    ctx.save_for_backward(*tensors)


def _gru_pass_backward(ctx, g):
    h, x, wzr, bzr, wq, bq = ctx.saved_tensors
    dh, dx, dwzr, dbzr, dwq, dbq = gru_pass_bwd(h, x, wzr, bzr, wq, bq, g, ctx.axis)
    return (dh, dx, dwzr.to(wzr.dtype), dbzr.to(bzr.dtype), dwq.to(wq.dtype),
            dbq.to(bq.dtype), None)


_gru_pass_op.register_autograd(_gru_pass_backward, setup_context=_gru_pass_setup)


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
    contiguous in h's dtype. Runs the operator ``dro_sfm::gru_sep1d_pass``:
    CUDA tensors go to kernel K5 (backward K6-input and K6-weight), CPU
    tensors to the plain versions, any other device raises.
    """
    _check(h, x, wzr, bzr, wq, bq, axis)
    return _gru_pass_op(h, x, wzr, bzr, wq, bq, axis)
