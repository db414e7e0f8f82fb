from pvcnn_tpu_torch.models.kitti.frustum import FrustumPointNet2
from pvcnn_tpu_torch.train.optim import CosineAnnealingLR
from pvcnn_tpu_torch.utils.config import Config, configs

# model
configs.model = Config(FrustumPointNet2)
configs.model.num_classes = configs.data.num_classes
configs.model.num_heading_angle_bins = configs.data.num_heading_angle_bins
configs.model.num_size_templates = configs.data.num_size_templates
configs.model.num_points_per_object = configs.data.num_points_per_object
configs.model.size_templates = configs.data.size_templates
configs.model.extra_feature_channels = 1

configs.train.batch_size = 24
configs.train.scheduler = Config(CosineAnnealingLR)
configs.train.scheduler.t_max = configs.train.num_epochs
