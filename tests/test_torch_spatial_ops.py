"""The operators of a height split (`dro_sfm_torch/parallel/spatial.py`) on
row bands of spawned gloo ranks (CPU), forward and backward, against the
port on the whole tensor and against the JAX function on the whole tensor.

Each operator class that reads rows beyond its band: the 3x3 convolution,
the 7x7 and 1x1 and 3x3 stride-2 convolutions, the (5,1) convolution, the
stem's max-pool (-inf beyond the image), the x2 bilinear resize from stride
16 to 8, the split and the fused (`gru_pass_plain` on the band widened by 4
rows) SepConvGRU, the convex upsampling's 3x3 neighbourhoods, the pose
head's mean over the plane, train-mode BatchNorm, the warp cost against the
gathered context maps (plain K1-K3) and the whole train-mode encoder; and
those of the photometric loss and the single-frame nets: the SSIM pool and
SSIM on the reflecting halo (bit for bit), the vertical difference (the last
band one row short), the decoder's nearest x2 from stride 32 (bit for bit;
on 80 rows band 1 starts on the odd row 3 at stride 16), the smoothness,
the whole loss in the ten settings of `tests/test_torch_photometric.py` (the
loss within 1e-6 of the whole port's; the gradients against JAX at that
file's 1e-4 relative L2), the perceptual term's share, `DepthDecoder` with
its scales resized to full resolution, and the train-mode `PoseResNet` (its
bands down to stride 32). Inputs and weights from numpy seeds; the
cotangent of the output is random. S = 2 on 80 rows (the stride-16 maps' 5
rows split 3 + 2) and S = 4 on 128 rows; the single-frame nets on 96 and
128.

Bars, those of `tests/test_spatial.py`: relative 1e-5 with an absolute
floor of 1e-5 times the larger of 1 and the reference's largest element,
for every operator's output and gradients. The whole encoder's output is
held to that bar (1e-4 against JAX: ten train-mode layers summed in another
order by XLA, as `tests/test_torch_modules.py` bars it), its gradients to
1e-3 in relative L2: a pre-ReLU value within rounding of zero takes the
other side of the kink in one summation order, which changes its gradient
whole and moves every layer below it (on the S = 2 case the port's
whole-tensor fp32 input gradient lies 3.3e-3 from fp64 at its largest
element, the bands' 1.1e-5 and JAX's 2.1e-5).
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.losses import photometric as jphoto
from dro_sfm_tpu.models import depth_pose_net as jdpn
from dro_sfm_tpu.models import encoder as jenc
from dro_sfm_tpu.models import single_frame as jsf
from dro_sfm_tpu.models import update as jupd
from dro_sfm_tpu.models.percep import PercepNet as JaxPercepNet
from dro_sfm_tpu.ops import image as jimage
from dro_sfm_tpu.ops.image import resize_bilinear as j_resize
from dro_sfm_tpu.ops.ssim import ssim_loss as j_ssim_loss
from dro_sfm_tpu.ops.upsample import convex_upsample as j_convex
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.geometry.camera import Camera, pixel_grid
from dro_sfm_torch.parallel import spatial
from tests._torch_dist import load, run_ranks
from tests._torch_spatial import CONVS, ops_rank, run_op
from tests.test_torch_modules import fill_variables
from tests.test_torch_photometric import CASES as PHOTOMETRIC_CASES

torch.set_num_threads(2)
HEIGHTS = {2: 80, 4: 128}          # image rows for S ranks
B, W8 = 2, 6                       # batch, columns at stride 8
# The single-frame nets' cases (bands down to stride 32, H >= 32 S, H a
# multiple of 32 for the U-Net's skips) and the nearest x2's from stride 32:
# 80 rows hold 3 at stride 32 and 5 at stride 16 (the x2's sixth row is
# beyond the image, its cotangent zero), so band 1 starts at stride 16 on
# the odd row 3 and reads row 1 of band 0.
SINGLE_FRAME_HEIGHTS = {2: 96, 4: 128}
NEAREST_HEIGHTS = {"nearest_x2": {2: 80, 4: 128}, "nearest_x2_96": {2: 96, 4: 160}}


def nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def flax_state(variables):
    return {k: v.numpy() for k, v in from_jax_variables(variables).items()}


def jax_vjp(fn, args, w):
    """JAX's output and the gradients of sum(output * w) for ``args``."""
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(w, y.dtype))
    y, grads = jax.jit(run)(*args)
    return np.asarray(y), [jax.tree_util.tree_map(np.asarray, g) for g in grads]


def photometric_inputs(rng, h, w, p=2, n=2):
    """`tests/test_torch_photometric.py:make_inputs` at ``h`` x ``w``."""
    K = np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2], [0, 0, 1.0]],
                 np.float32)
    return {"image": rng.uniform(size=(B, h, w, 3)).astype(np.float32),
            "context": rng.uniform(size=(B, n, h, w, 3)).astype(np.float32),
            "inv_depths": rng.uniform(0.1, 1.0, size=(p, B, h, w, 1)).astype(np.float32),
            "K": np.broadcast_to(K, (B, 3, 3)).copy(),
            "pose_vecs": rng.normal(0, 0.03, size=(B, n, p, 6)).astype(np.float32)}


def percep_fn_and_state(h, w, seed):
    """A JAX `PercepNet` without the resize as a function, and its weights
    in the port's names."""
    jnet = JaxPercepNet(resize=False)
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    variables = fill_variables(lambda k: jnet.init(k, dummy, dummy), seed=seed)
    return (lambda a, b: jnet.apply(variables, a, b)), flax_state(variables)


def make_case(name, s, rng):
    """(operator case, JAX's (output, {input: grad}, {param: grad}) on the
    whole tensor in the port's names and layouts)."""
    h = HEIGHTS[s]
    h8, w = h // 8, W8
    case = {"name": name, "height": h, "state": {}, "rows": {}, "fixed": ()}
    stats = {}                     # a flax module's BatchNorm statistics
    if name in CONVS:
        cin, cout, k, stride, pad, bias = CONVS[name]
        kh, kw = (k, k) if isinstance(k, int) else k
        ph, pw = (pad, pad) if isinstance(pad, int) else pad
        at = 1 if name == "conv7x7s2" else 8
        x = rng.normal(size=(B, cin, h // at, 2 * w)).astype(np.float32)
        wt = (rng.normal(size=(cout, cin, kh, kw)) / np.sqrt(cin * kh * kw)).astype(np.float32)
        case["state"] = {"weight": wt}
        if bias:
            case["state"]["bias"] = rng.normal(size=cout).astype(np.float32) * 0.1
        case.update(inputs={"x": x}, rows={"x": (2, at)}, out=(2, at * stride))

        def jfn(x_, wt_, *b_):
            y = jax.lax.conv_general_dilated(x_, wt_, (stride, stride), [(ph, ph), (pw, pw)],
                                             dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return y + b_[0][None, :, None, None] if b_ else y
        args = [x, wt] + ([case["state"]["bias"]] if bias else [])
        names = ["x", "weight", "bias"][:len(args)]
    elif name == "maxpool":
        x = rng.normal(size=(B, 3, h // 2, 2 * w)).astype(np.float32)
        case.update(inputs={"x": x}, rows={"x": (2, 2)}, out=(2, 4))

        def jfn(x_):
            return jax.lax.reduce_window(x_, -jnp.inf, jax.lax.max, (1, 1, 3, 3),
                                         (1, 1, 2, 2), ((0, 0), (0, 0), (1, 1), (1, 1)))
        args, names = [x], ["x"]
    elif name == "resize_x2":
        x = rng.normal(size=(B, 3, h // 16, w)).astype(np.float32)
        case.update(inputs={"x": x}, rows={"x": (2, 16)}, out=(2, 8))

        def jfn(x_):
            y = j_resize(jnp.moveaxis(x_, 1, -1), (2 * x_.shape[2], 2 * x_.shape[3]),
                         align_corners=False)
            return jnp.moveaxis(y, -1, 1)
        args, names = [x], ["x"]
    elif name in ("gru_split", "gru_fused"):
        hdim, cx = 8, 6
        hh = np.tanh(rng.normal(size=(B, h8, w, hdim))).astype(np.float32)
        xx = rng.normal(size=(B, h8, w, cx)).astype(np.float32)
        jm = jupd.SepConvGRU(hidden_dim=hdim, conv_impl="split")
        v = fill_variables(lambda k: jm.init(k, hh, xx), seed=int(rng.integers(100)))
        case.update(meta={"hdim": hdim, "cx": cx}, state=flax_state(v),
                    inputs={"h": nchw(hh), "x": nchw(xx)},
                    rows={"h": (2, 8), "x": (2, 8)}, out=(2, 8))

        def jfn(h_, x_, p_):
            y = jm.apply({"params": p_}, jnp.moveaxis(h_, 1, -1), jnp.moveaxis(x_, 1, -1))
            return jnp.moveaxis(y, -1, 1)
        args, names = [nchw(hh), nchw(xx), v["params"]], ["h", "x", "params"]
    elif name == "convex_upsample":
        depth = rng.uniform(0.1, 1.0, size=(1, B, h8, w, 1)).astype(np.float32)
        mask = rng.normal(size=(1, B, h8, w, 9 * 64)).astype(np.float32)
        case.update(inputs={"depth": depth, "mask": mask},
                    rows={"depth": (2, 8), "mask": (2, 8)}, out=(2, 1))
        jfn = lambda d_, m_: j_convex(d_, m_, ratio=8)                 # noqa: E731
        args, names = [depth, mask], ["depth", "mask"]
    elif name == "pose_head":
        x = rng.normal(size=(B, h8, w, 6)).astype(np.float32)
        jm = jupd.PoseHead(hidden_dim=8)
        v = fill_variables(lambda k: jm.init(k, x), seed=int(rng.integers(100)))
        case.update(meta={"cin": 6, "hidden": 8}, state=flax_state(v),
                    inputs={"x": nchw(x)}, rows={"x": (2, 8)}, out=None)
        jfn = lambda x_, p_: jm.apply({"params": p_}, jnp.moveaxis(x_, 1, -1))  # noqa: E731
        args, names = [nchw(x), v["params"]], ["x", "params"]
    elif name == "batchnorm":
        import flax.linen as fnn
        x = (rng.normal(size=(B, h8, w, 5)) * 2 + 1).astype(np.float32)
        jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        v = fill_variables(lambda k: jm.init(k, x), seed=int(rng.integers(100)))
        p_, st = v["params"], v["batch_stats"]
        case.update(meta={"c": 5}, state={
            "weight": np.asarray(p_["scale"]), "bias": np.asarray(p_["bias"]),
            "running_mean": np.asarray(st["mean"]), "running_var": np.asarray(st["var"]),
            "num_batches_tracked": np.array(0, np.int64)},
            inputs={"x": nchw(x)}, rows={"x": (2, 8)}, out=(2, 8))
        stats = v["batch_stats"]

        def jfn(x_, p_):
            y, _ = jm.apply({"params": p_, "batch_stats": stats}, jnp.moveaxis(x_, 1, -1),
                            mutable=["batch_stats"])
            return jnp.moveaxis(y, -1, 1)
        args, names = [nchw(x), v["params"]], ["x", "bn"]
    elif name == "warp_cost":
        c, n = 4, 2
        f1 = rng.normal(size=(B, h8, w, c)).astype(np.float32)
        fr = rng.normal(size=(B, n, h8, w, c)).astype(np.float32)
        depth = rng.uniform(1.0, 4.0, size=(B, h8, w, 1)).astype(np.float32)
        # rotations and translations that move pixels across the bands' edges
        pose = (rng.normal(size=(B, n, 6)) * [0.3, 0.6, 0.1, 0.05, 0.1, 0.02]).astype(np.float32)
        K = np.broadcast_to(np.array([[w * 0.9, 0, (w - 1) / 2], [0, w * 0.9, (h8 - 1) / 2],
                                      [0, 0, 1]], np.float32), (B, 3, 3)).copy()
        case.update(inputs={"fmap1": f1, "fmaps_ref": fr, "depth": depth, "pose": pose, "K": K},
                    rows={"fmap1": (1, 8), "fmaps_ref": (2, 8), "depth": (1, 8)},
                    out=(2, 8), fixed=("K",))

        def jfn(f1_, fr_, d_, p_):
            return jdpn.warp_cost(f1_, fr_, d_, p_, jnp.asarray(K), impl="gather")
        args, names = [f1, fr, depth, pose], ["fmap1", "fmaps_ref", "depth", "pose"]
    elif name == "encoder":
        x = rng.uniform(size=(B, h, 2 * w, 3)).astype(np.float32)
        jm = jenc.ResNetEncoder(out_chs=8)
        v = fill_variables(lambda k: jm.init(k, x, train=False), seed=int(rng.integers(100)))
        sd = flax_state(v)
        case.update(meta={"out": 8}, state=sd, inputs={"x": nchw(x)}, rows={"x": (2, 1)},
                    out=(2, 8))
        stats = v["batch_stats"]

        def jfn(x_, p_):
            y, _ = jm.apply({"params": p_, "batch_stats": stats}, jnp.moveaxis(x_, 1, -1),
                            train=True, mutable=["batch_stats"])
            return jnp.moveaxis(y, -1, 1)
        args, names = [nchw(x), v["params"]], ["x", "params"]
    elif name == "reflect_pool":
        x = rng.uniform(size=(B, h, 2 * w, 3)).astype(np.float32)
        case.update(inputs={"x": x}, rows={"x": (1, 1)}, out=(1, 1))
        jfn = jimage.avg_pool_3x3_reflect
        args, names = [x], ["x"]
    elif name == "ssim":
        x = rng.uniform(size=(B, 2, h, 2 * w, 3)).astype(np.float32)
        y_ = rng.uniform(size=(B, 1, h, 2 * w, 3)).astype(np.float32)
        case.update(inputs={"x": x, "y": y_}, rows={"x": (2, 1), "y": (2, 1)}, out=(2, 1))
        jfn = j_ssim_loss
        args, names = [x, y_], ["x", "y"]
    elif name == "gradient_y":
        x = rng.normal(size=(B, h, 2 * w, 2)).astype(np.float32)
        case.update(inputs={"x": x}, rows={"x": (1, 1)}, out=(1, 1))
        jfn = jimage.gradient_y
        args, names = [x], ["x"]
    elif name.startswith("nearest_x2"):
        h = NEAREST_HEIGHTS[name][s]
        x = rng.normal(size=(B, -(-h // 32), 3, 2)).astype(np.float32)
        case.update(height=h, deepest=32, inputs={"x": x}, rows={"x": (1, 32)}, out=(1, 16),
                    crop=-(-h // 16))
        jfn = lambda x_: jimage.resize_nearest(x_, (2 * x_.shape[1], 2 * x_.shape[2]))  # noqa
        args, names = [x], ["x"]
    elif name == "smoothness":
        inv = rng.uniform(0.1, 1.0, size=(2, B, h, 2 * w, 1)).astype(np.float32)
        img = rng.uniform(size=(B, h, 2 * w, 3)).astype(np.float32)
        case.update(inputs={"inv_depths": inv, "image": img},
                    rows={"inv_depths": (2, 1), "image": (1, 1)}, out=None, share=True)

        def jfn(inv_, img_):
            return jphoto.smoothness_loss(inv_, img_, jphoto.PhotometricLossConfig())
        args, names = [inv, img], ["inv_depths", "image"]
    elif name.startswith("photometric_"):
        setting = name[len("photometric_"):]
        inp = photometric_inputs(rng, h, 2 * w)
        cfg_kw = PHOTOMETRIC_CASES[setting]
        progress = 0.5 if setting == "progressive" else 0.0
        jpercep = None
        if cfg_kw.get("percep_loss_weight", 0) > 0:
            jpercep, state = percep_fn_and_state(h, 2 * w, int(rng.integers(100)))
            case["state"] = state
        case.update(meta={"cfg": cfg_kw, "progress": progress}, inputs=inp,
                    rows={"image": (1, 1), "context": (2, 1), "inv_depths": (2, 1)},
                    out=None, share=True, fixed=("image", "context", "K"))
        jcfg = jphoto.PhotometricLossConfig(**cfg_kw)

        def jfn(inv_, pose_):
            return jphoto.multiview_photometric_loss(
                jnp.asarray(inp["image"]), jnp.asarray(inp["context"]), inv_,
                jnp.asarray(inp["K"]), pose_, jcfg, percep_fn=jpercep, progress=progress)[0]
        args, names = [inp["inv_depths"], inp["pose_vecs"]], ["inv_depths", "pose_vecs"]
    elif name == "percep_share":
        img = rng.uniform(size=(B, h, 2 * w, 3)).astype(np.float32)
        warps = rng.uniform(size=(B, 2, h, 2 * w, 3)).astype(np.float32)
        jpercep, case["state"] = percep_fn_and_state(h, 2 * w, int(rng.integers(100)))
        case.update(inputs={"image": img, "warps": warps},
                    rows={"image": (1, 1), "warps": (2, 1)}, out=None, share=True)

        def jfn(img_, warps_):
            tgt = jnp.broadcast_to(img_[:, None], warps_.shape)
            return jpercep(tgt.reshape(-1, *warps_.shape[2:]),
                           warps_.reshape(-1, *warps_.shape[2:])).mean()
        args, names = [img, warps], ["image", "warps"]
    elif name == "depth_decoder":
        h, wf = SINGLE_FRAME_HEIGHTS[s], 64
        feats = [(rng.normal(size=(B, h >> (k + 1), wf >> (k + 1), c)) * 0.5).astype(np.float32)
                 for k, c in enumerate((64, 64, 128, 256, 512))]
        jm = jsf.DepthDecoder()
        v = fill_variables(lambda k: jm.init(k, feats), seed=int(rng.integers(100)))
        case.update(height=h, deepest=32, state=flax_state(v),
                    inputs={f"f{k}": nchw(f) for k, f in enumerate(feats)},
                    rows={f"f{k}": (2, 2 << k) for k in range(5)}, out=(2, 1))

        def jfn(*a):
            *fs, p_ = a
            outs = jm.apply({"params": p_}, [jnp.moveaxis(f, 1, -1) for f in fs])
            return jnp.stack([jimage.resize_nearest(d, (h, wf)) for d in outs[::-1]])
        args = [nchw(f) for f in feats] + [v["params"]]
        names = [f"f{k}" for k in range(5)] + ["params"]
    elif name == "pose_resnet":
        h, wf = SINGLE_FRAME_HEIGHTS[s], 64
        tgt = rng.uniform(size=(B, h, wf, 3)).astype(np.float32)
        refs = rng.uniform(size=(B, 2, h, wf, 3)).astype(np.float32)
        jm = jsf.PoseResNet()
        v = fill_variables(lambda k: jm.init(k, tgt, refs, train=False),
                           seed=int(rng.integers(100)))
        case.update(height=h, deepest=32, state=flax_state(v),
                    inputs={"target": tgt, "refs": refs},
                    rows={"target": (1, 1), "refs": (2, 1)}, out=None)
        stats = v["batch_stats"]

        def jfn(t_, r_, p_):
            y, _ = jm.apply({"params": p_, "batch_stats": stats}, t_, r_, train=True,
                            mutable=["batch_stats"])
            return y
        args, names = [tgt, refs, v["params"]], ["target", "refs", "params"]
    else:
        raise KeyError(name)
    probe = jax.eval_shape(jfn, *args)
    case["w"] = rng.normal(size=probe.shape).astype(np.float32)
    if "crop" in case:                  # rows beyond the image at the output's stride
        case["w"][(slice(None),) * case["out"][0] + (slice(case["crop"], None),)] = 0
    y, grads = jax_vjp(jfn, args, case["w"])
    jgrads, jparams = {}, {}
    for n_, g in zip(names, grads):
        if n_ == "params":
            jparams = {k: v.numpy() for k, v in from_jax_variables(
                {"params": g, "batch_stats": stats}).items()
                if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        elif n_ == "bn":
            jparams = {"weight": g["scale"], "bias": g["bias"]}
        elif n_ in ("weight", "bias"):
            jparams[n_] = g
        else:
            jgrads[n_] = g
    return case, (y, jgrads, jparams)


NAMES = list(CONVS) + ["maxpool", "resize_x2", "gru_split", "gru_fused", "convex_upsample",
                       "pose_head", "batchnorm", "warp_cost", "encoder", "reflect_pool", "ssim",
                       "gradient_y", "nearest_x2", "nearest_x2_96", "smoothness", "percep_share",
                       "depth_decoder", "pose_resnet"] + [
                           f"photometric_{k}" for k in PHOTOMETRIC_CASES]
# Train-mode ResNets: 1e-4 against JAX, and their gradients' relative L2 bar
# (see the docstring). At S = 4 oneDNN's CPU convolution takes a less
# accurate algorithm on the pose net's one-row bands: their input gradient
# lies 3.05e-3 from fp64 and from the whole port (4.7e-6 from fp64); with
# oneDNN off the bands lie 2.5e-6 from the whole port (`python -m
# tests._torch_spatial_reach op pose_resnet --shards 4`).
RESNETS = {"encoder": 1e-3, "pose_resnet": 5e-3}
# The loss terms' gradients against JAX: `tests/test_torch_photometric.py`'s
# relative L2 bar (a projection, a bilinear warp and the SSIM chain, each
# rounded in fp32 in another order); against the whole port elementwise.
# Through the VGG net 1e-3: at S = 4 (128x12) JAX's d inv_depths lies
# 2.555e-4 from the port's, whole and bands alike, which lie 3.7e-5 from
# fp64 (`python -m tests._torch_spatial_reach op photometric_percep
# --shards 4`).
LOSSES = {"smoothness": 1e-4, "percep_share": 1e-3, **{
    f"photometric_{k}": 1e-3 if "percep_loss_weight" in v else 1e-4
    for k, v in PHOTOMETRIC_CASES.items()}}
# The same taps in the same order on the band's rows and their halo.
BIT_EXACT = ("reflect_pool", "ssim", "gradient_y", "nearest_x2", "nearest_x2_96")


def assert_close(got, want, what, rtol=1e-5, l2=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if l2 is not None:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= l2, f"{what}: relative L2 {err:.3e} above {l2}"
        return
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())), err_msg=what)


def assemble(case, ranks, key, s):
    """The whole output, inputs' gradients and parameters' gradients from
    the ranks' bands: bands concatenated, whole inputs' and parameters'
    gradients summed."""
    outs = [r[key] for r in ranks]
    if case["out"] is None:
        for o in outs[1:]:                  # every rank holds the same value
            assert torch.equal(o[0], outs[0][0])
        y = outs[0][0]
    else:
        y = torch.cat([o[0] for o in outs], dim=case["out"][0])
    grads = {}
    for k in outs[0][1]:
        where = case["rows"].get(k)
        parts = [o[1][k] for o in outs]
        grads[k] = torch.cat(parts, dim=where[0]) if where else sum(parts)
    params = {k: sum(o[2][k] for o in outs) for k in outs[0][2]}
    return y, grads, params, [o[3] for o in outs]


@pytest.fixture(scope="module", params=[2, 4], ids=["S2", "S4"])
def split(request, tmp_path_factory):
    s = request.param
    rng = np.random.default_rng(s)
    made = {name: make_case(name, s, rng) for name in NAMES}
    cases = {name: c for name, (c, _) in made.items()}
    out = tmp_path_factory.mktemp(f"ops{s}")
    run_ranks(ops_rank, s, out, cases, str(out))
    ranks = load(out, s)
    shutil.rmtree(out)
    return s, made, ranks


@pytest.mark.parametrize("name", NAMES)
def test_band_matches_whole(split, name):
    s, made, ranks = split
    case, (jy, jgrads, jparams) = made[name]
    y, grads, params, buffers = assemble(case, ranks, name, s)
    wy, wgrads, wparams, wbuffers = run_op(case)         # the port, whole, no band
    if "crop" in case:                                    # the image's rows only
        dim, crop = case["out"][0], case["crop"]
        wy, jy = wy.narrow(dim, 0, crop), np.take(jy, range(crop), axis=dim)
    if name in BIT_EXACT:
        assert torch.equal(y, wy), f"{name}: the bands' output is not the whole's bits"
    if name.startswith("photometric_"):         # a loss on identical inputs
        rel = abs(float(y) - float(wy)) / abs(float(wy))
        assert rel <= 1e-6, f"{name}: loss {float(y)!r} vs {float(wy)!r} ({rel:.2e})"
    assert_close(y, wy, f"{name} output vs the whole port")
    jbar = 1e-4 if name in RESNETS else 1e-5
    l2 = RESNETS.get(name)                          # the ReLU kinks (docstring)
    assert_close(y, jy, f"{name} output vs JAX", jbar)
    assert set(grads) == set(wgrads) == set(jgrads), (set(grads), set(jgrads))
    for k in wgrads:
        assert_close(grads[k], wgrads[k], f"{name} d{k} vs the whole port", l2=l2)
        assert_close(grads[k], jgrads[k], f"{name} d{k} vs JAX", jbar,
                     l2=LOSSES.get(name, l2))
    assert set(params) == set(wparams)
    for k in wparams:
        assert_close(params[k], wparams[k], f"{name} d{k} vs the whole port", l2=l2)
        assert_close(params[k], jparams[k], f"{name} d{k} vs JAX", jbar, l2=l2)
    for b in buffers:                       # BatchNorm's statistics: the global batch's
        for k, v in wbuffers.items():
            if v.is_floating_point():
                assert_close(b[k], v, f"{name} {k}")


def test_pixel_grid_and_camera_hold_global_rows():
    """A band's pixel grid and lifted points are the whole image's rows of
    its band: without the row offset every band but the first would warp
    and reproject from the wrong rows."""
    h, w = 64, 8
    K = torch.tensor([[6.0, 0, 3.5], [0, 6.0, 31.5], [0, 0, 1]])
    depth = torch.rand(1, h, w, 1) + 1.0
    whole = Camera(K[None]).reconstruct(depth, frame="c")
    coords = Camera(K[None]).project(whole, frame="c")
    for s in (2, 4):
        for i in range(s):
            band = spatial.Band(h, s, i)
            r0, r1 = band.rows(1)
            with spatial.active(band):
                grid = pixel_grid(r1 - r0, w, row0=spatial.row_offset(r1 - r0))
                pts = Camera(K[None]).reconstruct(depth[:, r0:r1], frame="c")
                uv = Camera(K[None]).project(pts, frame="c")
            assert torch.equal(grid, pixel_grid(h, w)[r0:r1])
            assert torch.equal(pts, whole[:, r0:r1]) and torch.equal(uv, coords[:, r0:r1])


@pytest.mark.parametrize("height, shards, deepest, match", [
    pytest.param(72, 2, 16, "H/8 must divide by", id="72-2-H/8 must divide by"),
    pytest.param(60, 2, 16, "H/8 must divide by", id="60-2-H/8 must divide by"),
    pytest.param(16, 2, 16, "at least 2 rows at stride 8", id="16-2-at least 2 rows at stride 8"),
    pytest.param(48, 2, 32, "at least 4 rows at stride 8", id="48-2-stride32"),
    pytest.param(96, 4, 32, "at least 4 rows at stride 8", id="96-4-stride32"),
    pytest.param(72, 3, 32, "at least 4 rows at stride 8", id="72-3-stride32"),
    pytest.param(100, 2, 32, "H/8 must divide by", id="100-2-stride32")])
def test_band_refuses_heights(height, shards, deepest, match):
    with pytest.raises(ValueError, match=match):
        spatial.Band(height, shards, 0, deepest=deepest)


@pytest.mark.parametrize("deepest", [16, 32])
def test_band_height_rule(deepest):
    """The rule H >= deepest * S (H/8 divisible by S) is exactly the
    heights at which every band of S >= 2 holds at least one row at every
    stride down to ``deepest`` and a distinct number at each, so that an
    operator finds its stride from its rows: derived by counting the rows
    of every band of every H = 8kS, k < 40, S <= 8."""
    strides = [s for s in spatial.STRIDES if s <= deepest]
    for shards in range(2, 9):
        for k in range(1, 40):
            height = 8 * k * shards
            per = height // shards
            counts = [[-(-(i + 1) * per // s) + (-i * per // s) for s in strides]
                      for i in range(shards)]
            holds = all(min(c) >= 1 and len(set(c)) == len(c) for c in counts)
            assert holds == (height >= deepest * shards), (deepest, shards, k, counts)
            if holds:
                bands = [spatial.Band(height, shards, i, deepest=deepest) for i in range(shards)]
                for band, c in zip(bands, counts):
                    assert [band.stride_of(n) for n in c] == strides
            else:
                with pytest.raises(ValueError):
                    spatial.Band(height, shards, 0, deepest=deepest)


def test_bands_at_strides():
    """80 rows over 2: 5 + 5 rows at stride 8, 3 + 2 at stride 16, each a
    stride-2 layer's output band of the band above."""
    bands = [spatial.Band(80, 2, i) for i in range(2)]
    assert [b.rows(8) for b in bands] == [(0, 5), (5, 10)]
    assert [b.rows(16) for b in bands] == [(0, 3), (3, 5)]
    assert bands[0].stride_of(3) == bands[1].stride_of(2) == 16
    assert bands[0].stride_of(5) == bands[1].stride_of(5) == 8


def test_fetch_plan_runs_and_cache():
    """The GRU's 4 halo rows at stride 8 of 80 rows over 2 (5 + 5 rows): one
    buffer of band 0's rows below (5-8) then band 1's above (1-4); each rank
    fills its share as one run, and a plan is made once."""
    need = lambda r0, r1: (r0 - 4, r1 + 4)                              # noqa: E731
    needs = tuple(need(*spatial.Band(80, 2, 0).rows(8, j)) for j in range(2))
    plans = [spatial._fetch_plan(80, 2, i, 8, needs) for i in range(2)]
    assert [p.slots for p in plans] == [8, 8]
    assert [(p.start, p.n_above, p.n_below) for p in plans] == [(0, 0, 4), (4, 4, 0)]
    assert [p.runs for p in plans] == [((4, 1, 4),), ((0, 0, 4),)]
    assert [(p.fill_above, p.lo, p.hi, p.fill_below) for p in plans] == [
        (4, 0, 5, 0), (0, 0, 5, 4)]
    assert spatial._fetch_plan(80, 2, 1, 8, needs) is plans[1]
