"""Training command lines (counterpart of bigdl_tpu/models)."""
