"""Training entry point of the PyTorch/CUDA port
(``taming_event_flow_tpu_torch``), a twin of ``train_flow.py``::

    python train_flow_torch.py [--config configs/train_flow.yml]
                               [--path_mlflow DIR] [--path_cache DIR]
                               [--prev_runid RUNID] [--device cuda|cpu]

It reads the same configs, takes the same flags and writes the same
tracking layout (``mlruns/0/<runid>/``) as ``train_flow.py``, with the
checkpoint at ``artifacts/model/checkpoint.pt``. ``--prev_runid`` warm-starts
from a run of either package: a JAX run's ``checkpoint.msgpack`` gives the
weights, the Adam moments and step count, the epoch and the loss history.
One process runs on one device: the card by default, the CPU when asked
(``--device cpu``).

Several devices: launch one process per device with ``torchrun``::

    torchrun --nproc_per_node=K train_flow_torch.py --config ...

The ranks form the ``(data, event)`` mesh of ``train_flow.py``:
``parallel.event`` (default 1) ranks split each lane's events, and
``parallel.data`` (default the world over ``event``) split the batch lanes;
each rank streams its lanes from its shard of the files, and the gradients
are summed over the data axis and averaged over the event axis before the
clip (``parallel/event.py``). Only rank 0 writes the run, the checkpoint and
TensorBoard, and prints.

Pipeline: the loader streams per-lane windows on the host behind a
prefetch thread; every ``passes_loss`` windows are stacked into one window
(on one device the packed wire of ``runtime.packed_wire``, default on:
``training.window.stack_window``), copied to the device, and one train step
runs the model over all passes,
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
from taming_event_flow_tpu_torch.models import (
    build_model,
    optax_state_to_torch,
)
from taming_event_flow_tpu_torch.objectives import LossConfig
from taming_event_flow_tpu_torch.ops import set_deterministic, set_tf32
from taming_event_flow_tpu_torch.parallel import (
    exchange_flags,
    init_distributed,
    make_event_mesh,
    replicate,
    shard_window_2d,
    world_size,
)
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


def make_train_mesh(config):
    """The ``(data, event)`` mesh of ``train_flow.py:185-252``, or ``None``
    for one rank and no ``parallel`` shape (the one-device path).

    ``n_event = parallel.event or 1``, ``n_data = parallel.data or world /
    n_event``. Every rank is a process of its own, as on the JAX package's
    multi-host path: ``loader.seed`` and ``loader.n_events_pad`` are
    required (every rank must see the same file permutation, and window
    shapes that differ between ranks would hang the all-reduces), the data
    axis must divide the batch and the event axis ``loader.n_events_pad``.

    :raises ValueError: for a shape the world cannot hold, or a rule above.
    """
    par = config.get("parallel") or {}
    world = world_size()
    n_event = int(par.get("event") or 1)
    n_data = int(par.get("data") or max(world // n_event, 1))
    if world == 1 and n_data * n_event == 1:
        return None
    mesh = make_event_mesh(n_data, n_event)
    loader = config["loader"]
    if loader["batch_size"] % n_data:
        raise ValueError(f"batch_size {loader['batch_size']} not divisible "
                         f"by data axis {n_data}")
    n_pad = loader.get("n_events_pad")
    if loader.get("seed") is None or not n_pad:
        raise ValueError(
            "training over several ranks needs loader.seed (the same file "
            "permutation everywhere) and loader.n_events_pad (window shapes "
            "that differ between ranks would hang the all-reduces)")
    if n_pad % n_event:
        raise ValueError(f"n_events_pad {n_pad} not divisible by event axis "
                         f"{n_event}")
    return mesh


def train(args, config_parser: YAMLParser, device="cuda"):
    """Train as ``train_flow.train`` does, on ``device`` (the card unless
    the caller asks for the CPU; ``cuda:<LOCAL_RANK>`` under ``torchrun``).
    Returns the run id (rank 0's; the others return ``rank<r>``)."""
    dev = resolve_device(device)
    config = config_parser.config
    init_distributed(config.get("parallel"), device=dev)
    mesh = make_train_mesh(config)
    is_main = mesh is None or mesh.rank == 0

    if is_main:
        tracking.set_tracking_uri(args.path_mlflow)
        tracking.set_experiment(config["experiment"])
        run = tracking.start_run()
        runid = run.info.run_id
        tracking.log_params({k: str(v) for k, v in config.items()})
        tracking.log_params({"prev_runid": args.prev_runid})
    else:
        runid = f"rank{mesh.rank}"
    config = config_parser.combine_entries(config)
    config_parser.apply_runtime(config)
    meter = StepMeter()
    tb = None
    if is_main:
        print("Run id:", runid)
        save_diff("train_diff.txt")
        tb = TensorBoardMirror(runid)
    if mesh is not None and is_main:
        print(f"(data={mesh.n_data}, event={mesh.n_event}) mesh over "
              f"{mesh.n_data * mesh.n_event} ranks")

    res = tuple(config["loader"]["resolution"])
    batch_size = config["loader"]["batch_size"]
    passes = effective_passes(config)
    voxel = config["data"]["voxel"]
    num_bins = 2 if voxel is None else voxel

    # each rank streams the lanes of its data index from its shard of the
    # (identically permuted) files; the ranks of an event group stream the
    # same lanes
    local_batch, lane_lo, file_shard = batch_size, 0, None
    if mesh is not None:
        lane_lo, lane_hi = mesh.lanes(batch_size)
        local_batch = lane_hi - lane_lo
        config["loader"] = dict(config["loader"], batch_size=local_batch)
        if mesh.n_data > 1:
            file_shard = (mesh.data_index, mesh.n_data)
    data = H5Loader(config, shuffle=True, path_cache=args.path_cache,
                    lane_offset=lane_lo, file_shard=file_shard)

    # float32 throughout, as the JAX CLI's parity runs: no TF32
    set_tf32(False)
    set_deterministic()
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
        batched_sweep=bool(config["loss"].get("batched_sweep", False)),
    )
    optimizer = build_optimizer(
        config["optimizer"], model.parameters(),
        clip_grad=config["loss"].get("clip_grad"), device=dev,
    )
    state = init_train_state(model, local_batch, res[0], res[1], device=dev)

    # warm start (reference ``train_flow.py:63``), Adam moments included,
    # from a run of either package; every rank loads the checkpoint from
    # the shared store
    epoch = 0
    if args.prev_runid:
        ckpt, epoch = load_checkpoint(args.prev_runid)
        if ckpt is not None:
            model.load_state_dict(ckpt["model"])
            if ckpt.get("optax_state") is not None:
                optax_state_to_torch(ckpt["optax_state"], model, optimizer)
            elif ckpt["optimizer"] is not None:
                optimizer.load_state_dict(ckpt["optimizer"])
            state = state._replace(step=ckpt["step"])
            # replay the prior loss history into the new run
            # (reference ``utils/utils.py:33-44``)
            if is_main:
                for _, v, s in tracking.default_store().read_metric(
                    args.prev_runid, "loss"
                ):
                    tracking.log_metric("loss", v, step=s)
                    tb.add_scalar("loss", v, s)
    data.epoch = epoch

    if mesh is not None:
        # rank 0's weights and moments on every rank, checked bit for bit
        replicate(model, optimizer)
    step_fn = make_train_step(
        model, optimizer, loss_cfg,
        warping=config["loss"].get("warping", "Iterative"),
        flow_scaling=config["loss"].get("flow_scaling", 32), res=res,
        mesh=mesh)
    n_epochs = config["loader"]["n_epochs"]

    def window_stream():
        """Producer: owns all loader state; yields ordered stream events.

        ("reset", mask)      lanes changed sequence: zero their carry and
                             drop the partial loss window
        ("epoch_end", e, n)  epoch ``e`` finished after ``n`` stepped loss
                             windows (the reference counts one batch per
                             optimizer step, ``train_flow.py:119-121``)
        ("window", w, meta)  a full pass-stacked window of numpy arrays
                             (this rank's events of it on an event mesh)

        On a mesh the flags are exchanged every batch
        (``parallel.exchange_flags``): a lane reset anywhere drops every
        rank's partial window, and the epoch ends when every rank's lanes
        have finished it.
        """
        # the packed wire on one device (the mesh paths stack the plain
        # window, as train_flow.py does); exact, so the losses are the
        # plain wire's
        packed = mesh is None and bool(
            (config.get("runtime") or {}).get("packed_wire", True))
        net_compact = voxel is None
        window_batches = []
        windows_in_epoch = 0
        while True:
            batch = data.next_batch()
            new_seq = batch["new_seq"]
            epoch_done = data.seq_num >= len(data.files)
            reset = new_seq.any()
            if mesh is not None:
                every_lane, epoch_done = exchange_flags(new_seq, epoch_done,
                                                        mesh)
                reset = every_lane.any()
            if reset:
                window_batches = []
                yield ("reset", new_seq.copy())

            if epoch_done:  # epoch rollover
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
            # the count input derives on the device while no lane is
            # rectified (re-checked every window: a rectified file opening
            # mid-stream sets data.rectify, and later windows ship the
            # host-remapped input)
            window = stack_window(
                window_batches, packed=packed, net_compact=net_compact,
                derive_net=packed and net_compact and not data.rectify)
            if mesh is not None:
                window = shard_window_2d(window, mesh, local_lanes=True)
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
                # (the step's loss is summed over the data axis: the
                # global batch's)
                avg = train_loss / max(n_windows * batch_size, 1)
                if is_main:
                    tracking.log_metric("loss", avg, step=epoch_num)
                    tb.add_scalar("loss", avg, epoch_num)
                if avg < best_loss:
                    if is_main:
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

                if config["vis"].get("verbose") and is_main:
                    ev = window.get("event_txy", window.get("event_list"))
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
    if config["vis"].get("verbose") and is_main:
        print("\n" + tm.report())
    if is_main:
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
