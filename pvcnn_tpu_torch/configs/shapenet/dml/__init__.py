# deep-mutual-learning runs reuse the parent model config; train with
# python -m pvcnn_tpu_torch.train_dml
