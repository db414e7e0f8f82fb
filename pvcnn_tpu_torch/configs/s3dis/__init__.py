from pvcnn_tpu_torch.data.s3dis import S3DIS
from pvcnn_tpu_torch.evaluate.s3dis.eval import evaluate_from_configs
from pvcnn_tpu_torch.meters.s3dis import MeterS3DIS
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train.optim import Adam
from pvcnn_tpu_torch.utils.config import Config, configs

configs.data.num_classes = 13

# dataset configs
configs.dataset = Config(S3DIS)
configs.dataset.root = 'data/s3dis/pointcnn'
configs.dataset.with_normalized_coords = True

# evaluate configs
configs.evaluate = Config()
configs.evaluate.fn = evaluate_from_configs
configs.evaluate.num_votes = 1
configs.evaluate.batch_size = 10
configs.evaluate.dataset = Config(split='test')

# train configs
configs.train = Config()
configs.train.num_epochs = 50
configs.train.batch_size = 32

# train: meters
configs.train.meters = Config()
configs.train.meters['acc/iou_{}'] = Config(
    MeterS3DIS, metric='iou', num_classes=configs.data.num_classes)
configs.train.meters['acc/acc_{}'] = Config(
    MeterS3DIS, metric='overall', num_classes=configs.data.num_classes)

# train: metric for saving the best checkpoint
configs.train.metric = 'acc/iou_test'

# train: criterion
configs.train.criterion = Config(CrossEntropyLoss)

# train: optimizer
configs.train.optimizer = Config(Adam)
configs.train.optimizer.lr = 1e-3
