from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.train.optim import CosineAnnealingLR
from pvcnn_tpu_torch.utils.config import Config, configs

# model
configs.model = Config(PVCNN)
configs.model.num_classes = configs.data.num_classes
configs.model.num_shapes = configs.data.num_shapes
configs.model.extra_feature_channels = 3

configs.train.num_epochs = 250
configs.train.scheduler = Config(CosineAnnealingLR)
configs.train.scheduler.t_max = configs.train.num_epochs
