from pvcnn_tpu_torch.data.kitti import attributes as kitti
from pvcnn_tpu_torch.data.kitti.frustum import FrustumKitti
from pvcnn_tpu_torch.evaluate.kitti.frustum.eval import evaluate_from_configs
from pvcnn_tpu_torch.meters.kitti.frustum import MeterFrustumKitti
from pvcnn_tpu_torch.nn.frustum import FrustumPointNetLoss
from pvcnn_tpu_torch.train.optim import Adam
from pvcnn_tpu_torch.utils.config import Config, configs

# data configs
configs.data.num_points_per_object = 512
configs.data.num_heading_angle_bins = 12
configs.data.size_template_names = kitti.class_names
configs.data.num_size_templates = len(configs.data.size_template_names)
configs.data.class_name_to_size_template_id = {
    cat: cls for cls, cat in enumerate(configs.data.size_template_names)}
configs.data.size_templates = kitti.size_templates()

# dataset configs
configs.dataset = Config(FrustumKitti)
configs.dataset.root = 'data/kitti/frustum/frustum_data'
configs.dataset.num_points = 1024
configs.dataset.classes = configs.data.classes
configs.dataset.num_heading_angle_bins = configs.data.num_heading_angle_bins
configs.dataset.class_name_to_size_template_id = \
    configs.data.class_name_to_size_template_id
configs.dataset.random_flip = True
configs.dataset.random_shift = True
configs.dataset.frustum_rotate = True
configs.dataset.from_rgb_detection = False

# evaluate configs
configs.evaluate.fn = evaluate_from_configs
configs.evaluate.batch_size = 32
configs.evaluate.dataset = Config(split='val', from_rgb_detection=True)

# train configs
configs.train = Config()
configs.train.num_epochs = 209
configs.train.batch_size = 32

# train: meters
configs.train.meters = Config()
for name, metric in [
    ('acc/iou_3d_{}', 'iou_3d'), ('acc/acc_{}', 'accuracy'),
    ('acc/iou_3d_acc_{}', 'iou_3d_accuracy'),
    ('acc/iou_3d_class_acc_{}', 'iou_3d_class_accuracy'),
]:
    configs.train.meters[name] = Config(
        MeterFrustumKitti, metric=metric,
        num_heading_angle_bins=configs.data.num_heading_angle_bins,
        num_size_templates=configs.data.num_size_templates,
        size_templates=configs.data.size_templates,
        class_name_to_class_id={
            cat: cls for cls, cat in enumerate(configs.data.classes)})

# train: metrics for saving best checkpoints
configs.train.metrics = ('acc/iou_3d_class_acc_val', 'acc/iou_3d_acc_val')

# train: criterion
configs.train.criterion = Config(FrustumPointNetLoss)
configs.train.criterion.num_heading_angle_bins = \
    configs.data.num_heading_angle_bins
configs.train.criterion.num_size_templates = configs.data.num_size_templates
configs.train.criterion.size_templates = configs.data.size_templates
configs.train.criterion.box_loss_weight = 1.0
configs.train.criterion.corners_loss_weight = 10.0
configs.train.criterion.heading_residual_loss_weight = 20.0
configs.train.criterion.size_residual_loss_weight = 20.0

# train: optimizer
configs.train.optimizer = Config(Adam)
configs.train.optimizer.lr = 1e-3
