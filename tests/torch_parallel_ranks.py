"""Rank bodies of the port's multi-process tests
(``tests/test_torch_parallel*.py``).

Each function runs in a child process that
``taming_event_flow_tpu_torch.parallel.spawn.run_ranks`` starts with the
``spawn`` method, on the CPU with gloo, joined through a ``file://``
rendezvous of the test's own; it returns numpy results to the parent, which
alone imports JAX and compares them. This module imports nothing of JAX.
"""

import numpy as np
import torch


def _init(rank, world, url):
    """One thread a rank (the tests run beside each other), and the
    process group."""
    torch.set_num_threads(1)
    from taming_event_flow_tpu_torch.parallel import init_distributed

    assert init_distributed({"coordinator": url, "num_processes": world,
                             "process_id": rank}, device="cpu")


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _np(x):
    return x.detach().numpy().copy()


# --------------------------------------------------------------- training


def probe(rank, world, url):
    """Rank r contributes ``w (r + 1)``; the loss is ``|sum|^2``."""
    _init(rank, world, url)
    import torch.distributed as dist

    from taming_event_flow_tpu_torch.parallel import all_reduce_sum, pmean

    w = torch.tensor([1.0, 2.0], requires_grad=True)
    s = all_reduce_sum(w * (rank + 1), dist.group.WORLD)
    loss = (s ** 2).sum()
    loss.backward()
    m = pmean(torch.tensor([float(rank)]), dist.group.WORLD)
    return {"loss": float(loss.detach()), "grad": _np(w.grad),
            "pmean": float(m)}


def losses(rank, world, url, cases):
    """Each case's loss and flow gradient with this rank's events of an
    event mesh over the whole world."""
    _init(rank, world, url)
    from taming_event_flow_tpu_torch.objectives import (
        LOSS_REGISTRY,
        LossConfig,
    )
    from taming_event_flow_tpu_torch.parallel import make_event_mesh
    from taming_event_flow_tpu_torch.parallel.mesh import take

    mesh = make_event_mesh(1, world)
    out = []
    for warping, cfg_kw, flows, events, pol, gm in cases:
        lo, hi = mesh.events(events.shape[2])
        f = torch.from_numpy(flows).requires_grad_()
        shard = [torch.from_numpy(take(a, 2, lo, hi))
                 for a in (events, pol, gm)]
        loss = LOSS_REGISTRY[warping](f, *shard, LossConfig(**cfg_kw),
                                      event_axis=mesh.event_group)
        loss.backward()
        out.append({"loss": float(loss.detach()), "grad": _np(f.grad)})
    return out


def train_steps(rank, world, url, cases):
    """Each case: ``steps`` train steps on an ``(n_data, n_event)`` mesh
    (``make_train_step(..., mesh=)``) from the given weights and global
    window; the losses, parameters, this rank's carry and its lanes."""
    _init(rank, world, url)
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.parallel import (
        check_replicated,
        make_event_mesh,
        replicate,
        shard_state,
        shard_window_2d,
    )
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    out = []
    for case in cases:
        mesh = make_event_mesh(case["n_data"], case["n_event"])
        model = build_model(case["model"], num_bins=2, device="cpu")
        model.load_state_dict(_t(case["weights"]))
        opt = build_optimizer(case["opt"], model.parameters(),
                              clip_grad=case["clip"], device="cpu")
        replicate(model, opt)
        window = case["window"]
        b, (h, w) = window["event_list"].shape[1], case["loss"]["res"]
        state = shard_state(init_train_state(model, b, h, w, device="cpu"),
                            mesh)
        step = make_train_step(model, opt, LossConfig(**case["loss"]),
                               case["warping"],
                               flow_scaling=case["flow_scaling"], mesh=mesh)
        local = _t(shard_window_2d(window, mesh))
        losses = []
        for _ in range(case["steps"]):
            state, loss = step(state, local)
            losses.append(float(loss))
        check_replicated(list(model.state_dict().values()))
        out.append({
            "losses": losses,
            "params": {k: _np(v) for k, v in model.state_dict().items()},
            "grads": {k: _np(v.grad) for k, v in model.named_parameters()},
            "carry": [_np(c) for c in state.carry],
            "lanes": mesh.lanes(b),
        })
    return out


def mesh_errors(rank, world, url):
    """What a world of 2 refuses, and the flag exchange on both axes."""
    _init(rank, world, url)
    from taming_event_flow_tpu_torch.parallel import (
        exchange_flags,
        local_lane_range,
        make_event_mesh,
        make_multihost_event_mesh,
    )

    def raises(fn, exc=ValueError):
        try:
            fn()
        except exc as e:
            return str(e)
        return None

    data_mesh = make_event_mesh(2, 1)
    event_mesh = make_event_mesh(1, 2)
    lanes, done = exchange_flags(np.array([rank == 1]), rank == 0,
                                 data_mesh)
    same = exchange_flags(np.array([True, False]), True, event_mesh)
    return {
        "too_big": raises(lambda: make_event_mesh(2, 2)),
        "too_small": raises(lambda: make_event_mesh(1, 1)),
        "lanes": raises(lambda: data_mesh.lanes(3)),
        "world_lanes": raises(lambda: local_lane_range(3)),
        "lane_range": local_lane_range(4, data_mesh),
        "events": raises(lambda: event_mesh.events(5)),
        "flags": (lanes.tolist(), done),
        "event_flags": (same[0].tolist(), same[1]),
        "diverged": raises(lambda: exchange_flags(
            np.array([rank == 0]), False, event_mesh), RuntimeError),
        "multihost": (make_multihost_event_mesh(2).n_event,
                      raises(lambda: make_multihost_event_mesh(3))),
        "train_mesh": _train_meshes(raises),
    }


def _train_meshes(raises):
    """The training CLI's mesh choice in a world of 2: the mesh of a good
    config, and what three others are refused for."""
    import train_flow_torch

    def cfg(parallel, batch=2, seed=1, pad=64):
        return {"parallel": parallel, "loader": {
            "batch_size": batch, "seed": seed, "n_events_pad": pad}}

    mesh = train_flow_torch.make_train_mesh(cfg({"event": 2}))
    return ((mesh.n_data, mesh.n_event),
            [raises(lambda c=c: train_flow_torch.make_train_mesh(c))
             for c in (cfg({"data": 2}, batch=3), cfg({}, seed=None),
                       cfg({"event": 2}, pad=63))])


# ------------------------------------------------------------- evaluation

# ValState fields whose axis 2 is the event dimension
EVENT_FIELDS = ("event_ts", "event_loc", "pol_mask", "fw_loc", "fw_ts",
                "fw_mask", "bw_loc", "bw_mask")


def validation(rank, world, url, cases):
    """Each case: the passes through a validation scheme whose slots are
    sharded over the world, and through an unsharded one on this rank;
    the sharded reducers' values, and whether the sharded state is
    bitwise this rank's slice of the unsharded one."""
    _init(rank, world, url)
    from taming_event_flow_tpu_torch.metrics import METRIC_REGISTRY, ValConfig
    from taming_event_flow_tpu_torch.parallel import (
        make_eval_mesh,
        make_sharded_reducers,
        shard_eval_batch,
        shard_val_state,
    )

    mesh = make_eval_mesh()
    out = []
    for warping, cfg_kw, passes in cases:
        cfg = ValConfig(**cfg_kw)
        n = passes[0][1].shape[1]
        val = METRIC_REGISTRY[warping](cfg, 1, n // world, device="cpu")
        full = METRIC_REGISTRY[warping](cfg, 1, n, device="cpu")
        state, ref = val.init(), full.init()
        for k, (flow, ev, pol, emask) in enumerate(passes):
            flow, ev, pol, emask = (torch.from_numpy(a)
                                    for a in (flow, ev, pol, emask))
            ev_s, pol_s = shard_eval_batch(ev, pol, mesh)
            state = val.update(state, flow, ev_s, pol_s, emask,
                               n_active=k + 1)
            ref = full.update(ref, flow, ev, pol, emask, n_active=k + 1)
        sliced = shard_val_state(ref, mesh)
        red = make_sharded_reducers(val, mesh)
        rsat, fwl = red["rsat_fwl"](state)
        res = {
            "bitwise": all(torch.equal(getattr(state, f), getattr(sliced, f))
                           for f in EVENT_FIELDS),
            "fwl": float(red["fwl"](state)),
            "rsat": _np(red["rsat"](state)),
            "rsat_fwl": (_np(rsat), float(fwl)),
            "window_events": _np(red["window_events"](state)),
            "window_iwe_fw": _np(red["window_iwe_fw"](state)),
            "window_flow_bw": _np(val.window_flow(state, mode="backward")),
        }
        if cfg.track_bw or warping == "Linear":
            res["window_iwe_bw"] = _np(red["window_iwe_bw"](state))
        out.append(res)
    return out


def pipeline_windows(rank, world, url, cases):
    """Each case: an ``EvalPipeline`` over the world (sharded by itself)
    driven over the windows; the boundary metrics and launch counts."""
    _init(rank, world, url)
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    out = []
    for case in cases:
        model = build_model(case["model"], device="cpu")
        model.load_state_dict(_t(case["weights"]))
        pipe = EvalPipeline(case["config"], model, device="cpu")
        sharded = pipe.eval_mesh is not None
        pipe.cur_ridx = case["ridx"]
        mets = []
        for batches in case["windows"]:
            for b in batches:
                pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
            m = pipe.boundary_metrics(batches[-1], {"ts": 0.0})
            mets.append({k: np.asarray(v) for k, v in m.items()})
        out.append({"metrics": mets, "sharded": sharded,
                    "n_slots": pipe.n_slots,
                    "slots_here": pipe.criteria.n_events})
    return out


# ------------------------------------------------------------------ CLIs


def train_cli(rank, world, url, cfg_path, root):
    """``train_flow_torch.train`` on this rank; its return value."""
    _init(rank, world, url)
    import argparse

    import train_flow_torch
    from taming_event_flow_tpu_torch.configs import YAMLParser

    args = argparse.Namespace(config=cfg_path, path_mlflow=root,
                              path_cache="", prev_runid="")
    return train_flow_torch.train(args, YAMLParser(cfg_path), device="cpu")


def eval_cli(rank, world, url, runid, cfg_path, root, results):
    """``eval_flow_torch.test`` on this rank; its return value."""
    _init(rank, world, url)
    import argparse

    import eval_flow_torch
    from taming_event_flow_tpu_torch.configs import YAMLParser

    args = argparse.Namespace(runid=runid, config=cfg_path,
                              path_mlflow=root, path_results=results)
    return eval_flow_torch.test(args, YAMLParser(cfg_path), device="cpu")
