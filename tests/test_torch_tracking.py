"""The port's tracking against the JAX package's: the run store's on-disk
layout read across both ways, the checkpoint round trip (weights, Adam
moments and step count, step, epoch), the reference ``model.pth`` import,
the TensorBoard mirror, the git-diff artifact and the progress meters."""

import io
import os

import pytest
import torch

from taming_event_flow_tpu.tracking.store import TrackingStore as JaxStore
from taming_event_flow_tpu_torch import tracking
from taming_event_flow_tpu_torch.models import build_model
from taming_event_flow_tpu_torch.tracking import (
    TensorBoardMirror,
    TrackingStore,
    default_store,
    load_checkpoint,
    load_reference_torch_checkpoint,
    save_checkpoint,
)
from taming_event_flow_tpu_torch.training import build_optimizer
from taming_event_flow_tpu_torch.utils import ProgressBar, StepMeter, save_diff

TINY = {"name": "RecEVFlowNet", "base_channels": 8, "num_encoders": 2,
        "num_residual_blocks": 1, "min_size": 4, "final_w_scale": 0.01}


@pytest.fixture
def run(tmp_path):
    tracking.set_tracking_uri(str(tmp_path))
    tracking.set_experiment("tbtest")
    r = tracking.start_run()
    yield r
    tracking.end_run()


def _fill(store):
    r = store.start_run()
    store.log_params({"data": str({"mode": "time", "window": 0.01}),
                      "prev_runid": ""})
    for step, v in enumerate([1.0, 0.5, 0.25]):
        store.log_metric("loss", v, step=step)
    store.end_run()
    return r.info.run_id


def _tree(root):
    """Relative paths of every directory and file under ``root``."""
    out = set()
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            out.add(os.path.relpath(os.path.join(d, name), root))
    return out


@pytest.mark.parametrize("writer,reader", [(TrackingStore, JaxStore),
                                           (JaxStore, TrackingStore)],
                         ids=["port_to_jax", "jax_to_port"])
def test_store_layout_read_across(tmp_path, writer, reader):
    """A run one package writes, the other reads: params, the metric
    history, the artifact directory; and both lay out the same tree."""
    w = writer(str(tmp_path / "a"))
    w.set_experiment("e2e")
    rid = _fill(w)
    r = reader(str(tmp_path / "a"))
    run = r.get_run(rid)
    assert run.data.params == {"data": str({"mode": "time", "window": 0.01}),
                               "prev_runid": ""}
    assert [(v, s) for _, v, s in r.read_metric(rid, "loss")] == [
        (1.0, 0), (0.5, 1), (0.25, 2)]
    assert run.info.artifact_uri == os.path.abspath(
        os.path.join(str(tmp_path / "a"), "mlruns", "0", rid, "artifacts"))
    with pytest.raises(KeyError):
        r.get_run("missing")

    other = reader(str(tmp_path / "b"))
    other.set_experiment("e2e")
    rid_b = _fill(other)
    tree_a = {p.replace(rid, "<run>") for p in _tree(str(tmp_path / "a"))}
    tree_b = {p.replace(rid_b, "<run>") for p in _tree(str(tmp_path / "b"))}
    assert tree_a == tree_b
    with open(os.path.join(str(tmp_path / "a"), "mlruns", "0",
                           "meta.yaml")) as fa, open(os.path.join(
                               str(tmp_path / "b"), "mlruns", "0",
                               "meta.yaml")) as fb:
        assert fa.read().replace(str(tmp_path / "a"), "") == fb.read(
        ).replace(str(tmp_path / "b"), "")


def _trained(steps=3):
    """A tiny model and its Adam after ``steps`` updates on random
    gradients."""
    model = build_model(TINY, num_bins=2, device="cpu", seed=3)
    opt = build_optimizer({"name": "Adam", "lr": 1e-3}, model.parameters(),
                          clip_grad=100.0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return model, opt


def test_checkpoint_round_trip(run, capsys):
    model, opt = _trained()
    path = save_checkpoint(run.info.run_id, model.state_dict(),
                           opt.state_dict(), step=3, epoch=2)
    assert path.endswith(os.path.join("artifacts", "model", "checkpoint.pt"))
    assert not os.path.exists(path + ".tmp")

    ckpt, epoch = load_checkpoint(run.info.run_id)
    assert "Model restored from" in capsys.readouterr().out
    assert epoch == 2 and ckpt["step"] == 3 and ckpt["epoch"] == 2
    fresh, fresh_opt = _trained(steps=0)
    fresh.load_state_dict(ckpt["model"])
    fresh_opt.load_state_dict(ckpt["optimizer"])
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    ref, got = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    assert sorted(ref) == sorted(got) and len(ref) == len(list(
        model.parameters()))
    for k in ref:
        assert int(got[k]["step"]) == 3
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[k][moment], ref[k][moment]), (k, moment)
    # one more step moves both alike: the moments carried
    for m, o in ((model, opt), (fresh, fresh_opt)):
        for p in m.parameters():
            p.grad = torch.ones_like(p)
        o.step()
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


def test_load_checkpoint_without_one(run, capsys):
    assert load_checkpoint("no-such-run") == (None, 0)
    assert load_checkpoint(run.info.run_id) == (None, 0)
    assert "No model found" in capsys.readouterr().out


def test_load_reference_torch_checkpoint(tmp_path):
    """A ``model.pth`` holding a ``state_dict`` or a whole pickled module
    loads into the port's model as it is (the port's names are the
    reference's)."""
    model, _ = _trained(steps=0)
    for tag, obj in (("state_dict", model.state_dict()), ("module", model)):
        path = str(tmp_path / f"{tag}.pth")
        torch.save(obj, path)
        sd = load_reference_torch_checkpoint(path)
        fresh = build_model(TINY, num_bins=2, device="cpu", seed=9)
        fresh.load_state_dict(sd)
        for name, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[name], v), (tag, name)


def test_tensorboard_mirror_and_replay(run):
    prev_id = run.info.run_id
    for step, v in enumerate([1.0, 0.5, 0.3]):
        tracking.log_metric("loss", v, step=step)
    tracking.end_run()
    new = tracking.start_run()
    tb = TensorBoardMirror(new.info.run_id)
    if not tb.enabled:
        pytest.skip("no tensorboard writer available")
    tb.add_scalar("loss", 0.5, 0)
    assert tb.replay(prev_id, "loss") == 3
    tb.flush()
    tb.close()
    logdir = default_store().artifact_dir(new.info.run_id, "tensorboard")
    assert any("tfevents" in f for f in os.listdir(logdir))


def test_save_diff_and_meters(run):
    save_diff("train_diff.txt")
    assert os.path.isfile(os.path.join(run.info.artifact_uri,
                                       "train_diff.txt"))
    meter = StepMeter(window=2)
    assert meter.steps_per_s == 0.0
    for _ in range(4):
        meter.tick()
    assert meter.steps_per_s > 0 and len(meter._times) == 2
    assert meter.mevents_per_s(1e6) == pytest.approx(meter.steps_per_s)
    out = io.StringIO()
    bar = ProgressBar("eval", max=4, stream=out)
    bar.next(2)
    bar.finish()
    assert "2/4" in out.getvalue() and out.getvalue().endswith("\n")
