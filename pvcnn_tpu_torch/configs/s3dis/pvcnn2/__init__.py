from pvcnn_tpu_torch.models.s3dis import PVCNN2
from pvcnn_tpu_torch.train.optim import CosineAnnealingLR
from pvcnn_tpu_torch.utils.config import Config, configs

# model
configs.model = Config(PVCNN2)
configs.model.num_classes = configs.data.num_classes
configs.model.extra_feature_channels = 6
configs.dataset.num_points = 8192

configs.train.optimizer.weight_decay = 1e-5
configs.train.scheduler = Config(CosineAnnealingLR)
configs.train.scheduler.t_max = configs.train.num_epochs
