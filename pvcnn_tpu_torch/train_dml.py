"""python -m pvcnn_tpu_torch.train_dml <config.py> [--devices SPEC]
[--configs.x.y=z ...]

Deep mutual learning from a config of the port's tree (counterpart of the
JAX package's train_dml.py): two peers of the config's model train at
once (train/trainer.py:DMLTrainer), each loss adding the KL divergence to
the other's detached softmax. The teacher's weights are drawn with
configs.seed, the student's with seed + STUDENT_SEED_OFFSET, as
`python -m pvcnn_tpu_torch.train.dml` draws them; each peer has its own
optimizer from train.optimizer. `train.deep_mutual_learning=False`
trains the one model with the plain Trainer; `train.scheduler_unit=iter`
sets the lr before every step, a cosine schedule's t_max then counting
the steps of all epochs. Checkpoints as train/trainer.py:fit writes them
(the student's latest.pth.tar.student and best_student.pth.tar beside
the teacher's). With --evaluate the config's evaluator runs instead.
"""

from __future__ import annotations

__all__ = ["main", "run"]


def run(configs) -> tuple:
    """Train (or resume) what a prepared config describes by deep mutual
    learning -> (the teacher's last meters, the student's; {} without
    DML)."""
    from pvcnn_tpu_torch.nn.loss import KLLoss
    from pvcnn_tpu_torch.train.cli import train_config
    from pvcnn_tpu_torch.train.trainer import (STUDENT_SEED_OFFSET,
                                               DMLTrainer, Trainer)
    from pvcnn_tpu_torch.utils.weights import init_random_

    device = configs.device

    def make_trainer(model, criterion, optimizer, seed):
        if not configs.train.get("deep_mutual_learning", True):
            return Trainer(model, criterion, optimizer, device, seed)
        student = init_random_(configs.model(),
                               seed + STUDENT_SEED_OFFSET).to(device)
        return DMLTrainer(model, criterion, optimizer, student,
                          configs.train.optimizer(student.parameters()),
                          KLLoss(), device, seed)

    scores = train_config(configs, make_trainer,
                          configs.train.get("scheduler_unit", "epoch"))
    return scores[""], scores.get("_student", {})


def main(argv=None):
    from pvcnn_tpu_torch.train.cli import prepare

    configs = prepare(argv)
    if configs.evaluate is not None:
        return configs.evaluate.fn(configs)
    return run(configs)


if __name__ == "__main__":
    main()
