from pvcnn_tpu_torch.data.shapenet import ShapeNet
from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate_from_configs
from pvcnn_tpu_torch.meters.shapenet import MeterShapeNet
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train.optim import Adam
from pvcnn_tpu_torch.utils.config import Config, configs

configs.data.num_classes = 50
configs.data.num_shapes = 16
# ShapeNet item work (resample, jitter, one-hot) is GIL-bound numpy: worker
# processes parallelize it, threads do not
configs.data.workers_mode = "process"

# dataset configs
configs.dataset = Config(ShapeNet)
configs.dataset.root = \
    'data/shapenet/shapenetcore_partanno_segmentation_benchmark_v0_normal'
configs.dataset.with_normal = True
configs.dataset.with_one_hot_shape_id = True
configs.dataset.normalize = True
configs.dataset.jitter = True
configs.dataset.num_points = 2048

# evaluate configs
configs.evaluate = Config()
configs.evaluate.fn = evaluate_from_configs
configs.evaluate.num_votes = 10
configs.evaluate.batch_size = 32
configs.evaluate.dataset = Config(split='test')

# train configs
configs.train = Config()
configs.train.num_epochs = 200
configs.train.batch_size = 32

# train: meters
configs.train.meters = Config()
configs.train.meters['acc/iou_{}'] = Config(
    MeterShapeNet, num_classes=configs.data.num_classes)

# train: metric for saving the best checkpoint
configs.train.metric = 'acc/iou_test'

# train: criterion
configs.train.criterion = Config(CrossEntropyLoss)

# train: optimizer
configs.train.optimizer = Config(Adam)
configs.train.optimizer.lr = 1e-3
