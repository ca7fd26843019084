"""Parallelism (counterpart of bigdl_tpu/parallel): the pipeline over
stage modules, run on one device so far."""
