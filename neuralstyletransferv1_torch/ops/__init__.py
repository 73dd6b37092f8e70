"""Tensor ops on NHWC / HWC tensors (counterparts of neuralstyletransferv1_tpu.ops)."""
