"""Import a reference pretrained checkpoint (``model.pth``) into a tracked
run of the PyTorch/CUDA port, beside ``scripts/import_torch_checkpoint.py``.

The port's parameter names are the reference's, so the weights go into the
run's ``artifacts/model/checkpoint.pt`` as they are, and
``eval_flow_torch.py <runid>`` evaluates them::

    python scripts/import_torch_checkpoint_torch.py path/to/model.pth \
        [--path_mlflow DIR] [--config configs/train_flow.yml]

The train config is logged as run params, so the eval CLI rebuilds the
model and the protocol (``merge_configs``) as for a run trained here.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from taming_event_flow_tpu_torch import tracking  # noqa: E402
from taming_event_flow_tpu_torch.configs import YAMLParser  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint", help="reference model.pth")
    parser.add_argument("--path_mlflow", default="")
    parser.add_argument("--config", default="configs/train_flow.yml")
    args = parser.parse_args(argv)

    state_dict = tracking.load_reference_torch_checkpoint(args.checkpoint)

    config = YAMLParser(args.config).config
    tracking.set_tracking_uri(args.path_mlflow)
    tracking.set_experiment(config.get("experiment", "Default"))
    run = tracking.start_run()
    tracking.log_params({k: str(v) for k, v in config.items()})
    tracking.save_checkpoint(run.info.run_id, state_dict)
    tracking.end_run()
    print("Imported checkpoint into run:", run.info.run_id)
    return run.info.run_id


if __name__ == "__main__":
    main()
