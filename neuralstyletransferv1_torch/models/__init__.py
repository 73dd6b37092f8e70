"""Network definitions (counterparts of neuralstyletransferv1_tpu.models)."""
