"""The port's config tree: the twin of the JAX package's configs/, file
for file and value for value, naming the port's classes; two keys differ
(no train.presort, the TPU-only batch presort; data.num_workers below),
as tests/test_torch_configs.py:DIFFERS records. Load a leaf with
`python -m pvcnn_tpu_torch.train pvcnn_tpu_torch/configs/<dataset>/...py`
(train/cli.py); each file is executed, with the __init__.py of every
directory from here down to it (utils/config.py)."""

from pvcnn_tpu_torch.utils.config import Config, configs

configs.seed = 1588147245
configs.deterministic = True  # read by neither package

# data configs
configs.data = Config()
# item-fetch workers (the reference's configs/__init__.py:8 runs 16): 0,
# the serial loader with prefetch 2, which measured faster on the card than
# 16 workers (train/trainer.py:add_host_arguments); workers_mode keeps the
# JAX configs' values for runs that ask for workers
configs.data.num_workers = 0
configs.data.workers_mode = "thread"
