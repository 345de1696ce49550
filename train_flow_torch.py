"""Training entry point of the PyTorch/CUDA port
(``taming_event_flow_tpu_torch``), a twin of ``train_flow.py``::

    python train_flow_torch.py [--config configs/train_flow.yml]
                               [--path_mlflow DIR] [--path_cache DIR]
                               [--prev_runid RUNID] [--device cuda|cpu]

It reads the same configs, takes the same flags and writes the same
tracking layout (``mlruns/0/<runid>/``) as ``train_flow.py``, with the
checkpoint at ``artifacts/model/checkpoint.pt``. One device: the card by
default, the CPU when asked (``--device cpu``).

Pipeline: the loader streams per-lane windows on the host behind a
prefetch thread; every ``passes_loss`` windows are stacked into one window,
copied to the device, and one train step runs the model over all passes,
evaluates the contrast-max loss (``loss.warping``: Iterative or Linear),
backprops, clips and applies Adam. Every model of the registry trains
(``model.name``), on count or voxel inputs (``data.voxel``). Sequence
changes zero the affected lanes' recurrent carry and restart the loss
window.
"""

import argparse

import torch

from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import H5Loader, Prefetcher
from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.ops import set_tf32
from taming_event_flow_tpu_torch.tracking import (
    TensorBoardMirror,
    load_checkpoint,
    save_checkpoint,
)
from taming_event_flow_tpu_torch.training import (
    build_optimizer,
    init_train_state,
    make_train_step,
    reset_carry,
    stack_window,
)
from taming_event_flow_tpu_torch.utils import (
    SectionTimer,
    StepMeter,
    resolve_device,
    save_diff,
)


def effective_passes(config) -> int:
    """Mode "four" doubles the loss window (the reference mutates the config
    inside the loss ctor, ``loss/flow.py:422-423``; we do it explicitly)."""
    p = config["data"]["passes_loss"]
    if (
        config["loss"].get("warping") == "Iterative"
        and config["loss"].get("iterative_mode") == "four"
    ):
        p *= 2
    return p


def check_supported(config) -> None:
    """Raise for what the port's trainer does not run yet: more than one
    device (the model options it lacks raise in ``build_model``, the loss
    options in the loss)."""
    par = config.get("parallel") or {}
    if int(par.get("data") or 1) > 1 or int(par.get("event") or 1) > 1:
        raise NotImplementedError(
            f"parallel {par} is not ported yet: the port trains on one "
            "device; see ROADMAP.md (multi-device, item 7)")


def train(args, config_parser: YAMLParser, device="cuda"):
    """Train as ``train_flow.train`` does, on ``device`` (the card unless
    the caller asks for the CPU). Returns the run id."""
    dev = resolve_device(device)
    config = config_parser.config
    check_supported(config)

    tracking.set_tracking_uri(args.path_mlflow)
    tracking.set_experiment(config["experiment"])
    run = tracking.start_run()
    runid = run.info.run_id
    tracking.log_params({k: str(v) for k, v in config.items()})
    tracking.log_params({"prev_runid": args.prev_runid})
    config = config_parser.combine_entries(config)
    config_parser.apply_runtime(config)
    print("Run id:", runid)

    meter = StepMeter()
    save_diff("train_diff.txt")
    tb = TensorBoardMirror(runid)

    res = tuple(config["loader"]["resolution"])
    batch_size = config["loader"]["batch_size"]
    passes = effective_passes(config)
    voxel = config["data"]["voxel"]
    num_bins = 2 if voxel is None else voxel

    data = H5Loader(config, shuffle=True, path_cache=args.path_cache)

    # float32 throughout, as the JAX CLI's parity runs: no TF32
    set_tf32(False)
    model = build_model(dict(config["model"]), num_bins=num_bins,
                        device=dev, seed=config["loader"].get("seed") or 0)
    loss_cfg = LossConfig(
        res=res,
        passes_loss=passes,
        scales_loss=config["data"]["scales_loss"],
        iterative_mode=config["loss"].get("iterative_mode", "two"),
        round_ts=config["loss"].get("round_ts", False),
        flow_spat_smooth_weight=config["loss"].get("flow_spat_smooth_weight"),
        flow_temp_smooth_weight=config["loss"].get("flow_temp_smooth_weight"),
        warp_remat=bool(config["loss"].get("warp_remat", False)),
        scan_unroll=int(config["loss"].get("scan_unroll", 1)),
        batched_sweep=bool(config["loss"].get("batched_sweep", False)),
        triangular_warp=bool(config["loss"].get("triangular_warp", True)),
    )
    optimizer = build_optimizer(
        config["optimizer"], model.parameters(),
        clip_grad=config["loss"].get("clip_grad"), device=dev,
    )
    state = init_train_state(model, batch_size, res[0], res[1], device=dev)

    # warm start (reference ``train_flow.py:63``), Adam moments included
    epoch = 0
    if args.prev_runid:
        ckpt, epoch = load_checkpoint(args.prev_runid)
        if ckpt is not None:
            model.load_state_dict(ckpt["model"])
            if ckpt["optimizer"] is not None:
                optimizer.load_state_dict(ckpt["optimizer"])
            state = state._replace(step=ckpt["step"])
            # replay the prior loss history into the new run
            # (reference ``utils/utils.py:33-44``)
            for _, v, s in tracking.default_store().read_metric(
                args.prev_runid, "loss"
            ):
                tracking.log_metric("loss", v, step=s)
                tb.add_scalar("loss", v, s)
    data.epoch = epoch

    step_fn = make_train_step(
        model, optimizer, loss_cfg,
        warping=config["loss"].get("warping", "Iterative"),
        flow_scaling=config["loss"].get("flow_scaling", 32),
        res=res,
    )
    n_epochs = config["loader"]["n_epochs"]

    def window_stream():
        """Producer: owns all loader state; yields ordered stream events.

        ("reset", mask)      lanes changed sequence: zero their carry and
                             drop the partial loss window
        ("epoch_end", e, n)  epoch ``e`` finished after ``n`` stepped loss
                             windows (the reference counts one batch per
                             optimizer step, ``train_flow.py:119-121``)
        ("window", w, meta)  a full pass-stacked window of numpy arrays
        """
        window_batches = []
        windows_in_epoch = 0
        while True:
            batch = data.next_batch()
            new_seq = batch["new_seq"]
            if new_seq.any():
                window_batches = []
                yield ("reset", new_seq.copy())

            if data.seq_num >= len(data.files):  # epoch rollover
                yield ("epoch_end", data.epoch, windows_in_epoch)
                windows_in_epoch = 0
                data.epoch += 1
                data.samples = 0
                data.seq_num = data.seq_num % len(data.files)
                if data.epoch == n_epochs:
                    return

            window_batches.append(batch)
            if len(window_batches) < passes:
                continue
            window = stack_window(window_batches)
            window_batches = []
            windows_in_epoch += 1
            yield ("window", window, (data.epoch, data.seq_num))

    # wall-clock attribution of the consumer loop (printed with vis.verbose)
    tm = SectionTimer()
    train_loss, best_loss = 0.0, 1.0e6
    windows_done = 0
    # losses are read back one step late, so the host never waits on the
    # step in flight (float() synchronises)
    pending = []

    def drain(limit):
        nonlocal train_loss, windows_done
        with tm("loss_readback"):
            while len(pending) > limit:
                train_loss += float(pending.pop(0))
                windows_done += 1

    prefetcher = Prefetcher(window_stream(), depth=3)
    try:
        for event in tm.wrap(prefetcher, "wait_window"):
            if event[0] == "reset":
                drain(1)
                state = state._replace(carry=reset_carry(
                    state.carry, torch.from_numpy(event[1]).to(dev)))
            elif event[0] == "epoch_end":
                _, epoch_num, n_windows = event
                drain(0)
                # one batch_size increment per optimizer step (reference
                # train_flow.py:119-121)
                avg = train_loss / max(n_windows * batch_size, 1)
                tracking.log_metric("loss", avg, step=epoch_num)
                tb.add_scalar("loss", avg, epoch_num)
                if avg < best_loss:
                    save_checkpoint(runid, model.state_dict(),
                                    optimizer.state_dict(),
                                    step=state.step, epoch=epoch_num)
                    best_loss = avg
                train_loss = 0.0
                windows_done = 0
            else:
                _, window, (epoch_num, seq_num) = event
                with tm("window_place"):
                    window = {k: torch.from_numpy(v).to(dev)
                              for k, v in window.items()}
                with tm("step_dispatch"):
                    state, loss = step_fn(state, window)
                pending.append(loss)
                drain(1)
                meter.tick()

                if config["vis"].get("verbose"):
                    ev = window["event_list"]
                    ev_per_step = float(
                        ev.shape[0] * ev.shape[1] * ev.shape[2])
                    print(
                        f"Train Epoch: {epoch_num:04d} "
                        f"[{seq_num:03d}/{len(data.files):03d}] "
                        f"Loss: {train_loss / max(windows_done * batch_size, 1):.6f} "
                        f"({meter.steps_per_s:.2f} step/s, "
                        f"{meter.mevents_per_s(ev_per_step):.1f} Mev/s)",
                        end="\r",
                    )
        drain(0)
    finally:
        prefetcher.close()
        data.close()
    if config["vis"].get("verbose"):
        print("\n" + tm.report())
    tb.close()
    tracking.end_run()
    return runid


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--config", default="configs/train_flow.yml",
        help="training configuration",
    )
    parser.add_argument(
        "--path_mlflow", default="", help="tracking-store location"
    )
    parser.add_argument(
        "--path_cache", default="",
        help="location of the cached formatted dataset",
    )
    parser.add_argument(
        "--prev_runid", default="",
        help="pre-trained model to use as starting point",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device to train on: cuda (the default) or cpu",
    )
    args = parser.parse_args()
    train(args, YAMLParser(args.config), device=args.device)
