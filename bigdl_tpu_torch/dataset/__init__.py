"""Data pipeline (counterpart of bigdl_tpu/dataset): in-memory and
iterator datasets, and the PTB text path."""
