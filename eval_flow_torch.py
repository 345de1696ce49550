"""Evaluation entry point of the PyTorch/CUDA port
(``taming_event_flow_tpu_torch``), a twin of ``eval_flow.py``::

    python eval_flow_torch.py <runid> [--config configs/eval_flow.yml]
                              [--path_mlflow DIR] [--path_results DIR]
                              [--device cuda|cpu]

It rebuilds the training config from the tracked run, streams GT-aligned
windows at batch 1, runs the run's model (any of the registry's four, on
count or voxel inputs) and the Iterative or Linear validation
(``metrics.warping``), and at every ``passes_loss`` boundary computes FWL,
RSAT and AEE (on the window's backward flow, the DSEC submission
quantity). It writes what ``eval_flow.py`` writes:
``<path_results>/<runid>/eval_<id>.yml``, ``metrics_<id>.yml`` with the
per-sequence averages, and the image tree
``results/eval_<id>/<sequence>/<panel>/%09d.png`` with ``timestamps.txt``,
which ``prepare_dsec_submission.py`` turns into a DSEC-Flow submission.
The weights come from the run's ``artifacts/model/checkpoint.pt``, or from
the ``checkpoint.msgpack`` of a run the JAX package trained. One
process runs on one device: the card by default, the CPU when asked
(``--device cpu``).

Several devices: ``torchrun --nproc_per_node=K eval_flow_torch.py <runid>
...`` shards the validation slot state's event axis over the K ranks, as
``eval_flow.py`` shards it over its devices (``pipeline/eval.py``). Every
rank streams the same batches and runs every collective; rank 0 alone reads
the metrics back and writes ``metrics_*.yml``, the PNGs and the submission
tree.

The ``runtime`` wires are the JAX pipeline's (``pipeline/eval.py``):
``packed_wire`` and ``u32_wire`` on by default, ``probe_wire`` off.
``loss.matmul_precision``, ``loss.warp_backend`` and the other
``runtime`` keys parse and do nothing.
"""

import argparse

import torch
import torch.distributed as dist

from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.configs import YAMLParser
from taming_event_flow_tpu_torch.data import H5Loader, Prefetcher
from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.ops import (
    compute_pol_iwe,
    set_deterministic,
    set_tf32,
)
from taming_event_flow_tpu_torch.parallel import init_distributed, shared_seed
from taming_event_flow_tpu_torch.pipeline import (
    EvalPipeline,
    MetricsConsumer,
    batch_stream,
)
from taming_event_flow_tpu_torch.tracking import load_checkpoint
from taming_event_flow_tpu_torch.tracking.loggers import (
    create_model_dir,
    log_config,
    log_results,
)
from taming_event_flow_tpu_torch.utils import (
    ProgressBar,
    Visualization,
    resolve_device,
)


def load_weights(model, runid: str, device) -> None:
    """Load the run's checkpoint into ``model``: its ``checkpoint.pt``, or
    the JAX package's ``checkpoint.msgpack`` for a run that package made.
    A run without any checkpoint keeps the seeded initial weights, with a
    warning, as ``eval_flow.py`` does."""
    ckpt, _ = load_checkpoint(runid, map_location=device)
    if ckpt is None:
        print("WARNING: no checkpoint found for run; evaluating random init")
        return
    model.load_state_dict(ckpt["model"])


def test(args, config_parser: YAMLParser, device="cuda"):
    """Evaluate run ``args.runid`` as ``eval_flow.test`` does, on ``device``
    (the card unless the caller asks for the CPU; ``cuda:<LOCAL_RANK>``
    under ``torchrun``). Returns ``{metric: {sequence: str(mean)}}`` on
    rank 0, ``None`` on the others."""
    dev = resolve_device(device)
    is_main = not init_distributed(device=dev) or dist.get_rank() == 0
    tracking.set_tracking_uri(args.path_mlflow)
    run = tracking.get_run(args.runid)
    config = config_parser.merge_configs(run.data.params)
    config = config_parser.combine_entries(config)
    config_parser.apply_runtime(config)

    config["loader"]["batch_size"] = 1
    # every rank must stream the same batches in the same order
    config["loader"]["seed"] = shared_seed(config["loader"].get("seed"))
    res = tuple(config["loader"]["resolution"])
    voxel = config["data"]["voxel"]
    num_bins = 2 if voxel is None else voxel

    vis = None
    if is_main:
        path_results = create_model_dir(args.path_results, args.runid)
        eval_id = log_config(path_results, args.runid, config)
        vis = Visualization(config, eval_id=eval_id,
                            path_results=path_results)

    data = H5Loader(config, shuffle=True)

    # float32 throughout unless the config asks for a bf16 forward
    set_tf32(False)
    set_deterministic()
    model = build_model(dict(config["model"]), num_bins=num_bins, device=dev)
    load_weights(model, args.runid, dev)

    pipe = EvalPipeline(config, model, device=dev)
    want_vis, tm = pipe.vis.want, pipe.tm
    metric_names = pipe.metric_names
    # boundary metrics are read back on a reader thread, off the dispatch
    # loop (on rank 0: the others run the same collectives and drop them)
    consumer = MetricsConsumer(metric_names) if is_main else None

    bar = None
    prefetcher = Prefetcher(batch_stream(data, pipe), depth=3)
    try:
        with torch.inference_mode():
            for batch, meta in tm.wrap(prefetcher, "wait_batch"):
                sequence = meta["sequence"]
                pipe.cur_ridx = meta["remap_idx"]
                pipe.cur_rect = meta.get("rect_map")

                if pipe.vis.bars and is_main:
                    if bar is None:
                        bar = ProgressBar(sequence, max=meta["bar_iters"])
                    bar.next()

                if batch["new_seq"].any():
                    if bar is not None:
                        bar.finish()
                        bar = ProgressBar(sequence, max=meta["bar_iters"])
                    pipe.start_sequence()

                if pipe.gtflow_mode and batch["ts_jump_reset"].any():
                    pipe.ts_jump_flush()

                if meta["end_test"]:
                    break

                batch = pipe.ensure_bucket(batch)
                flow_fine = pipe.ingest(batch, meta)

                # the vis slots every rank computes (their reducers are
                # collectives); rank 0 alone stores them
                window_images = pipe.vis_window_images()
                if not is_main:
                    if pipe.passes_done == pipe.passes:
                        pipe.boundary_outputs(batch, meta)
                    continue

                flow_vis = None
                if want_vis("flow") or want_vis("iwe"):
                    flow_vis = flow_fine
                    if pipe.vis.mask_output:
                        flow_vis = flow_vis * torch.as_tensor(
                            batch["event_mask"], device=dev)

                if want_vis("iwe"):
                    vis.data["iwe"] = compute_pol_iwe(
                        flow_vis,
                        torch.as_tensor(batch["event_list"], device=dev),
                        res,
                        torch.as_tensor(batch["event_list_pol_mask"],
                                        device=dev),
                        round_idx=False, round_flow=False,
                    )

                vis.data.update(window_images)

                vis.data["flow_bw"] = None
                if pipe.passes_done == pipe.passes:
                    dev_mets, flow_bw = pipe.boundary_outputs(batch, meta)
                    if flow_bw is not None:
                        # the device's u16 map: the vis writeback thread
                        # copies it to the host
                        vis.data["flow_bw"] = flow_bw
                    if dev_mets is not None:
                        consumer.put(dev_mets, sequence)

                if pipe.vis.on:
                    with tm("vis_step"):
                        vis.data["flow"] = flow_vis
                        vis.step(batch, sequence=sequence, ts=meta["ts"],
                                 show=pipe.vis.show)
    finally:
        prefetcher.close()
        data.close()
        if is_main:
            # drain the metric readbacks (re-raises any reader error)
            val_results = consumer.close()
            # flush the PNG writeback thread, surfacing any worker error,
            # before the results are logged: the submission formatter
            # reads the image tree right after this returns
            vis.close()

    if not is_main:
        return None
    if pipe.vis.verbose:
        print(tm.report())

    results = {}
    for metric in metric_names:
        results[metric] = {}
        for key in val_results:
            if val_results[key][metric]["it"] > 0:
                results[metric][key] = str(
                    val_results[key][metric]["metric"]
                    / val_results[key][metric]["it"]
                )
    log_results(args.runid, results, path_results, eval_id)
    print(results)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("runid", help="tracked run id")
    parser.add_argument(
        "--config", default="configs/eval_flow.yml",
        help="config file, overwrites tracked settings",
    )
    parser.add_argument("--path_mlflow", default="",
                        help="tracking-store location")
    parser.add_argument("--path_results", default="results_inference/")
    parser.add_argument(
        "--device", default="cuda",
        help="device to evaluate on: cuda (the default) or cpu",
    )
    args = parser.parse_args()
    test(args, YAMLParser(args.config), device=args.device)
