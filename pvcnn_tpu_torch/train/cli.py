"""The config-driven entry points' two halves (counterpart of the JAX
package's train.py: prepare and main).

`prepare(argv)` reads `<config.py> ... [--devices SPEC] [--evaluate]
[--configs.x.y=z ...]`: it selects the device (utils/device.py:
cuda:0 without --devices, refused without CUDA), loads the config files
into a cleared `configs` singleton, sets the save path
(runs/<dataset>.<model>..., utils/common.py), applies the overrides, and
then either sets the training paths (the checkpoint layout
train/trainer.py:fit writes, and `train.metrics`: `train.metric` first,
then `train.metrics`) or, with --evaluate, merges `evaluate.dataset` into
`dataset` and sets the evaluation paths: `evaluate.best_checkpoint_path`
(by default <save path>/best.pth.tar; .pth.tar or .pth) and the
`predictions_path` (.predictions) and `stats_path` (.eval.npy) of its
stem. The singleton is cleared first, so one process can prepare several
runs in turn.

`run(configs)` trains what a prepared config describes with the port's
Trainer and `fit`: the config's dataset, split by name, in DataLoaders
of `data.num_workers` workers in `data.workers_mode` (shuffled train
split) at `train.batch_size`; `configs.model()` on the selected device
with seeded random weights (utils/weights.py:init_random_, as the
per-dataset entry points draw them); the criterion, the optimizer over
the model's parameters, the scheduler bound to the optimizer's lr, and
the meters of the evaluated split. The seed (`configs.seed`) seeds the
weights, the readers' generators, the loader's shuffle and the
trainer's dropout and sampler generators; the port draws nothing from
numpy's or Python's global state, so neither is seeded. Two keys that no
config file sets are read where an override gives them:
`train.max_steps` (steps an epoch at most, the per-dataset entry points'
--max-steps) and `train.profile` (trace steps 1-5 of the first epoch
into <save path>/profile).
Between the two calls a caller may set what a command line cannot carry,
such as `configs.dataset.opener` (an in-memory data/s3dis.py:WindowStore).
"""

from __future__ import annotations

import argparse
import os

__all__ = ["prepare", "run", "train_config"]


def prepare(argv=None):
    """Parse a command line (sys.argv[1:] without `argv`) into the
    `configs` singleton -> configs (see the module docstring)."""
    from pvcnn_tpu_torch.utils.common import get_save_path
    from pvcnn_tpu_torch.utils.config import configs
    from pvcnn_tpu_torch.utils.device import select_device

    parser = argparse.ArgumentParser()
    parser.add_argument("configs", nargs="+")
    parser.add_argument("--devices", default=None,
                        help="'cpu' runs on the CPU; one index ('0', "
                             "'gpu1') names that card; the default is "
                             "cuda:0")
    parser.add_argument("--evaluate", default=False, action="store_true")
    args, opts = parser.parse_known_args(argv)

    configs.clear()
    configs.device = select_device(args.devices)

    print(f"==> loading configs from {args.configs}")
    configs.update_from_modules(*args.configs)
    configs.train.save_path = get_save_path(*args.configs, prefix="runs")
    configs.update_from_arguments(*opts)

    if args.evaluate and configs.evaluate.get("fn") is not None:
        if "dataset" in configs.evaluate:
            for k, v in configs.evaluate.dataset.items():
                configs.dataset[k] = v
    else:
        configs.evaluate = None

    if configs.evaluate is None:
        metrics = []
        if configs.train.get("metric") is not None:
            metrics.append(configs.train.metric)
        for m in configs.train.get("metrics") or ():
            if m not in metrics:
                metrics.append(m)
        configs.train.metrics = metrics
        configs.train.metric = metrics[0] if metrics else None

        save_path = configs.train.save_path
        configs.train.checkpoint_path = os.path.join(save_path,
                                                     "latest.pth.tar")
        configs.train.checkpoints_path = os.path.join(save_path, "latest",
                                                      "e{}.pth.tar")
        configs.train.best_checkpoint_path = os.path.join(save_path,
                                                          "best.pth.tar")
        configs.train.best_checkpoint_paths = {
            m: os.path.join(save_path, "best", "best.{}.pth.tar".format(
                m.replace("/", ".")))
            for m in configs.train.metrics
        }
    else:
        if configs.evaluate.get("best_checkpoint_path") is None:
            configs.evaluate.best_checkpoint_path = (
                configs.train.get("best_checkpoint_path")
                or os.path.join(configs.train.save_path, "best.pth.tar"))
        path = configs.evaluate.best_checkpoint_path
        if path.endswith(".ckpt"):
            raise ValueError(
                f"{path}: a JAX .ckpt checkpoint; the port reads .pth.tar "
                "and .pth files (the machine with the card has no msgpack "
                "reader)")
        stem = next((path[:-len(ext)] for ext in (".pth.tar", ".pth")
                     if path.endswith(ext)), None)
        if stem is None:
            raise ValueError(f"evaluate.best_checkpoint_path must end in "
                             f".pth.tar or .pth, got {path!r}")
        configs.evaluate.predictions_path = stem + ".predictions"
        configs.evaluate.stats_path = stem + ".eval.npy"
    return configs


def train_config(configs, make_trainer, scheduler_unit: str = "epoch"):
    """run()'s body for any trainer: `make_trainer(model, criterion,
    optimizer, seed)` -> the Trainer that `fit` trains (a DMLTrainer
    for train_dml). -> fit's {peer suffix: last meters}."""
    from pvcnn_tpu_torch.data.loader import DataLoader
    from pvcnn_tpu_torch.train.trainer import fit
    from pvcnn_tpu_torch.utils.weights import init_random_

    print(configs)
    seed = configs.get("seed") or 0
    dataset = configs.dataset(seed=seed)
    others = [split for split in dataset if split != "train"]
    if "train" not in dataset or len(others) != 1:
        raise ValueError(f"splits {list(dataset)}: training needs 'train' "
                         "and one split to score")
    data = configs.data
    loaders = {split: DataLoader(
        dataset[split], configs.train.batch_size, shuffle=(split == "train"),
        seed=seed, num_workers=data.get("num_workers", 0),
        workers_mode=data.get("workers_mode", "thread")) for split in dataset}
    model = init_random_(configs.model(), seed).to(configs.device)
    optimizer = configs.train.optimizer(model.parameters())
    scheduler = None
    if configs.train.get("scheduler") is not None:
        scheduler = configs.train.scheduler().bind(
            configs.train.optimizer.lr)
    trainer = make_trainer(model, configs.train.criterion(), optimizer, seed)
    meters = configs.train.meters
    return fit(trainer, loaders["train"], loaders[others[0]],
               lambda: {k.format(others[0]): meter()
                        for k, meter in meters.items()},
               configs.train.metrics, epochs=configs.train.num_epochs,
               save_path=configs.train.save_path, scheduler=scheduler,
               scheduler_unit=scheduler_unit,
               max_steps=configs.train.get("max_steps"),
               profile=bool(configs.train.get("profile")))


def run(configs) -> dict:
    """Train (or resume) the model a prepared config describes -> the last
    evaluation's meters, with each metric's best."""
    from pvcnn_tpu_torch.train.trainer import Trainer

    def make_trainer(model, criterion, optimizer, seed):
        return Trainer(model, criterion, optimizer, configs.device, seed)
    return train_config(configs, make_trainer)[""]
