from pvcnn_tpu_torch.models.s3dis import PointNet
from pvcnn_tpu_torch.train.optim import MultiStepLR
from pvcnn_tpu_torch.utils.config import Config, configs

# model
configs.model = Config(PointNet)
configs.model.num_classes = configs.data.num_classes
configs.model.extra_feature_channels = 6
configs.dataset.num_points = 4096

configs.train.scheduler = Config(MultiStepLR)
configs.train.scheduler.milestones = [5, 10, 15, 20, 25, 30, 35]
configs.train.scheduler.gamma = 0.5
