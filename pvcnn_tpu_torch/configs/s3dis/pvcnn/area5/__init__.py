from pvcnn_tpu_torch.utils.config import configs

configs.dataset.holdout_area = 5
