"""Request time of an exported serving artifact on the card.

    python -m dro_sfm_torch.scripts.export --checkpoint x.ckpt --output serve/ --platforms cuda
    python -m dro_sfm_torch.scripts.bench_serving serve/ [--batch 1] [--steps 20]

The port's counterpart of `tools/bench_serving.py`. Loads the artifact's
CUDA program (`export_serving.load_serving_artifact`), answers a first
request and `WARMUP` more, then times ``--steps`` requests back to back with CUDA events
(seeded inputs already on the card). Prints one JSON line:
``serving_ms_per_batch``, ``frames_per_sec``, the batch and shapes, the
seconds of the load and the first call, and the card's name and power
limit. It needs the card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

WARMUP = 3                          # requests after the first, before the timing


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dro_sfm_torch serving artifact timing")
    ap.add_argument("artifact")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch (dynamic-batch artifacts only); 0 = the exported "
                         "signature's batch")
    ap.add_argument("--steps", type=int, default=20)
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from dro_sfm_torch.export_serving import example_inputs, load_serving_artifact
    from dro_sfm_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    t0 = time.perf_counter()
    art = load_serving_artifact(args.artifact, device)
    load_s = time.perf_counter() - t0
    sig = art.meta["signature"]
    if args.batch and sig["target"][0] != "b" and args.batch != sig["target"][0]:
        raise ValueError(f"the artifact's batch is {sig['target'][0]}; --batch "
                         f"{args.batch} needs a --dynamic-batch export")
    b = args.batch or (1 if sig["target"][0] == "b" else sig["target"][0])
    h, w, n = sig["target"][1], sig["target"][2], sig["refs"][1]
    inputs = example_inputs(b, n, (h, w), device)
    t0 = time.perf_counter()
    art.call(*inputs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(WARMUP):
        art.call(*inputs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(args.steps):
        art.call(*inputs)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.steps
    result = {"serving_ms_per_batch": ms, "frames_per_sec": b / ms * 1e3, "batch": b,
              "image_shape": [h, w], "views": n, "steps": args.steps, "load_s": load_s,
              "first_call_s": first_s, "device": torch.cuda.get_device_name(device),
              "card": card_line()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
