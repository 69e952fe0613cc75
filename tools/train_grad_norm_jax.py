"""Gradient norm of the JAX package's supervised training step at random
weights: the reference's behaviour at the training benchmark's operating
point (`bench.py`), for comparison with the PyTorch port.

Builds `SupModelMF` it12-h-out as `bench.py` does (random weights from
``PRNGKey(0)``, the benchmark's synthetic batch, the config-default Adam
and StepLR), optionally scales the last convolution of every depth and pose
head by ``--head-scale``, and prints, for one step of `make_train_step`:
the loss, the global gradient norm (the same loss and gradient the step
takes), the number of gradient elements whose square overflows fp32, and
the number of elements of Adam's second moment that are not finite after
the step.

    python tools/train_grad_norm_jax.py --batch 1 --height 192 --width 640
    python tools/train_grad_norm_jax.py --batch 1 --head-scale 0.1

Off a TPU ``warp_impl="pallas"`` is the JAX package's matmul sampler with
bf16 weights, so the warp is ``"gather"``. ``--max-rss-gib``
ends the process when its resident memory passes that size.
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def watch_memory(limit_gib: float) -> None:
    def run():
        while True:
            with open("/proc/self/status") as f:
                rss = next(int(line.split()[1]) for line in f if line.startswith("VmRSS"))
            if rss > limit_gib * 2**20:
                print(f"resident memory {rss / 2**20:.1f} GiB passed "
                      f"{limit_gib} GiB: stopping", flush=True)
                os._exit(3)
            time.sleep(0.2)

    threading.Thread(target=run, daemon=True).start()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--head-scale", type=float, default=1.0)
    ap.add_argument("--max-rss-gib", type=float, default=24.0)
    args = ap.parse_args()
    watch_memory(args.max_rss_gib)

    import jax
    import jax.numpy as jnp

    from dro_sfm_tpu.models.sfm import (
        SfmModelConfig,
        forward_and_loss,
        resolve_memory_policy,
    )
    from dro_sfm_tpu.training.state import create_train_state, make_optimizer
    from dro_sfm_tpu.training.step import make_train_step
    from dro_sfm_tpu.utils.config import load_config

    b, n, h, w = args.batch, 2, args.height, args.width
    rng = np.random.default_rng(0)
    K = np.array([[w * 0.8, 0, (w - 1) / 2], [0, w * 0.8, (h - 1) / 2],
                  [0, 0, 1.0]], dtype=np.float32)
    batch = {
        "rgb": jnp.asarray(rng.uniform(size=(b, h, w, 3)), jnp.float32),
        "rgb_context": jnp.asarray(rng.uniform(size=(b, n, h, w, 3)), jnp.float32),
        "intrinsics": jnp.broadcast_to(jnp.asarray(K), (b, 3, 3)),
        "depth": jnp.asarray(rng.uniform(1.0, 60.0, size=(b, h, w, 1)), jnp.float32),
        "pose_context": jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (b, n, 4, 4)),
    }
    remat, unroll = resolve_memory_policy("auto", "auto", b, (h, w))
    model_cfg = SfmModelConfig(name="SupModelMF", version="it12-h-out",
                               min_depth=0.2, max_depth=80.0, flip_lr_prob=0.5,
                               mixed_precision=True, remat=remat,
                               scan_unroll=unroll, warp_impl="gather")
    net = model_cfg.build_net()
    cfg = load_config()
    tx = make_optimizer(cfg.model.optimizer, cfg.model.scheduler, steps_per_epoch=1000)
    state = create_train_state(
        net, jax.random.PRNGKey(0),
        {k: batch[k] for k in ("rgb", "rgb_context", "intrinsics")}, tx)

    def scale(path, x):
        keys = [getattr(p, "key", str(p)) for p in path]
        if "head" in keys and "conv2" in keys and keys[-1] == "kernel":
            return x * args.head_scale
        return x

    state = state.replace(params=jax.tree_util.tree_map_with_path(scale, state.params))
    step_rng = jax.random.PRNGKey(1)

    @jax.jit
    def grads_of(state):
        # the loss and gradient of make_train_step's first update
        def loss_fn(params):
            variables = {"params": params, "batch_stats": state.batch_stats}
            return forward_and_loss(model_cfg, net, variables, batch,
                                    jax.random.fold_in(step_rng, state.step))
        return jax.value_and_grad(loss_fn, has_aux=True)(state.params)

    t0 = time.perf_counter()
    (loss, _), grads = grads_of(state)
    leaves = [np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(grads)]
    norm = float(np.sqrt(sum((g * g).sum() for g in leaves)))
    overflow = sum(int((g * g > np.finfo(np.float32).max).sum()) for g in leaves)
    print(f"JAX SupModelMF it12-h-out {h}x{w} N={n} B={b} "
          f"bf16 warp_impl=gather remat={remat} head_scale={args.head_scale}: "
          f"loss {float(loss):.6f}, "
          f"gradient norm {norm:.6e}, {overflow} of {sum(g.size for g in leaves)} "
          f"gradient elements with g^2 beyond fp32 "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)

    t0 = time.perf_counter()
    state, metrics = make_train_step(model_cfg, net)(state, batch, step_rng)
    moments = [np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_state)
               if hasattr(x, "dtype") and np.issubdtype(x.dtype, np.floating)]
    bad = sum(int((~np.isfinite(x)).sum()) for x in moments)
    print(f"make_train_step: loss {float(metrics['loss']):.6f}, {bad} elements of "
          f"the optimizer state not finite after the step "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
