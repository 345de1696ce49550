"""Low-latency streaming flow inference with the PyTorch/CUDA port
(``taming_event_flow_tpu_torch``): the deployment loop of
``examples/streaming_inference.py``, on the card.

A recurrent model consumes short event slices and emits a flow map per
slice, its carry threaded from one pass to the next::

    python examples/streaming_inference_torch.py [--runid ID --path_mlflow DIR]
                                                 [--torch_checkpoint model.pth]
                                                 [--height 480 --width 640]
                                                 [--n_events 32768]
                                                 [--passes 200]
                                                 [--wire f32|u16]
                                                 [--device cuda|cpu]

``--runid`` restores a tracked run of either package (its
``checkpoint.pt``, or the JAX package's ``checkpoint.msgpack``) and
rebuilds the run's model from its params; ``--torch_checkpoint`` loads a
reference ``model.pth`` as it is. Without either it streams through the
seeded default model, which is enough to measure the latency.

Each pass uploads a slice of synthetic events (drawn from
``np.random.default_rng(0)`` in the JAX example's order, so both see the
same events), encodes the per-polarity counts on the device
(``ops.events_to_channels``), runs the model (``training.make_forward_fn``)
and reads the finest flow map back: float32, or on the ``u16`` wire the
DSEC 16-bit lattice (``utils.flow_to_u16``, half the bytes, at most 1/128
px off), decoded on the host. The read-back is the sync point, so a
pass's latency covers all of it. Each pass is a ``stream_pass`` range in
a ``utils.profile_trace`` profile. ``PERF.md`` holds the card's figures.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from taming_event_flow_tpu_torch import tracking  # noqa: E402
from taming_event_flow_tpu_torch.configs import YAMLParser  # noqa: E402
from taming_event_flow_tpu_torch.models import build_model  # noqa: E402
from taming_event_flow_tpu_torch.ops import events_to_channels  # noqa: E402
from taming_event_flow_tpu_torch.training import make_forward_fn  # noqa: E402
from taming_event_flow_tpu_torch.utils import (  # noqa: E402
    annotate,
    flow_to_u16,
    resolve_device,
    u16_to_flow,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runid", default="", help="tracked run to restore")
    ap.add_argument("--path_mlflow", default="")
    ap.add_argument("--torch_checkpoint", default="",
                    help="reference model.pth to import")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--n_events", type=int, default=32768)
    ap.add_argument("--passes", type=int, default=200)
    ap.add_argument("--flow_scaling", type=float, default=32.0)
    ap.add_argument("--wire", choices=["f32", "u16"], default="f32",
                    help="flow-map readback format: u16 ships the DSEC "
                         "16-bit lattice (half the bytes; <= 1/128 px "
                         "quantization, utils.flow_to_u16)")
    ap.add_argument("--device", default="cuda",
                    help="device to stream on: cuda (the default) or cpu")
    return ap.parse_args(argv)


def load_model(args, device):
    """The model to stream: the run's (its config rebuilt from the run's
    params, as ``eval_flow_torch.py`` does) or the default RecEVFlowNet,
    with the weights of ``--torch_checkpoint`` or of the run."""
    model_cfg = {"name": "RecEVFlowNet"}
    if args.runid:
        tracking.set_tracking_uri(args.path_mlflow)
        run_cfg = YAMLParser().merge_configs(
            tracking.get_run(args.runid).data.params)
        model_cfg = dict(run_cfg["model"])
        if run_cfg["data"].get("voxel") is not None:
            raise SystemExit(
                "this example streams the count encoding; run with a "
                f"count-input checkpoint (run {args.runid} trained on "
                f"{run_cfg['data']['voxel']}-bin voxels)")
    model = build_model(model_cfg, num_bins=2, device=device)
    if args.torch_checkpoint:
        model.load_state_dict(
            tracking.load_reference_torch_checkpoint(args.torch_checkpoint))
        print(f"imported torch checkpoint {args.torch_checkpoint}")
    elif args.runid:
        ckpt, _ = tracking.load_checkpoint(args.runid, map_location=device)
        if ckpt is None:
            raise SystemExit(f"no checkpoint for run {args.runid}")
        model.load_state_dict(ckpt["model"])
        print(f"restored run {args.runid}")
    return model


def read_map(flow: torch.Tensor, wire: str) -> np.ndarray:
    """The consumer's read-back of one ``[1, H, W, 2]`` flow map."""
    if wire == "u16":
        return u16_to_flow(flow_to_u16(flow).cpu().numpy())
    return flow.cpu().numpy()


def stream(args):
    """Stream ``args.passes`` timed slices after one warm-up slice.

    :return: ``(last flow map [1, H, W, 2] as read back, latencies in ms
        per timed pass)``.
    """
    dev = resolve_device(args.device)
    res = (args.height, args.width)
    model = load_model(args, dev)
    forward = make_forward_fn(model, flow_scaling=args.flow_scaling)
    carry = model.init_state(1, *res, device=dev)
    rng = np.random.default_rng(0)

    def synthetic_slice():
        ev = np.zeros((1, args.n_events, 4), np.float32)
        ev[..., 0] = np.sort(rng.uniform(0, 1, (1, args.n_events)))
        ev[..., 1] = rng.integers(0, res[0], (1, args.n_events))
        ev[..., 2] = rng.integers(0, res[1], (1, args.n_events))
        ev[..., 3] = rng.choice([-1.0, 1.0], (1, args.n_events))
        return ev

    def one_pass(ev):
        nonlocal carry
        with annotate("stream_pass"):
            ev = torch.from_numpy(ev).to(dev)
            x = events_to_channels(ev[0, :, 2], ev[0, :, 1], ev[0, :, 3],
                                   res)[None]
            flows, carry = forward(carry, x)
            return read_map(flows[-1], args.wire)

    one_pass(synthetic_slice())  # warm-up: cuDNN picks its algorithms
    lat, flow = [], None
    for _ in range(args.passes):
        ev = synthetic_slice()  # stand-in for the event camera
        t0 = time.perf_counter()
        flow = one_pass(ev)
        lat.append(time.perf_counter() - t0)
    return flow, np.array(lat) * 1e3


def main(argv=None):
    args = parse_args(argv)
    flow, lat_ms = stream(args)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU")
    print(
        f"{args.passes} passes at {args.height}x{args.width}, "
        f"{args.n_events} events/slice, {args.wire} wire, on {name}:\n"
        f"  latency p50 {np.percentile(lat_ms, 50):.3f} ms   "
        f"p99 {np.percentile(lat_ms, 99):.3f} ms   "
        f"mean {lat_ms.mean():.3f} ms "
        f"({1e3 / lat_ms.mean():.1f} flow maps/s)\n"
        f"  (each pass = upload + encode + recurrent forward + full-map "
        f"readback; flow shape {flow.shape})")


if __name__ == "__main__":
    main()
