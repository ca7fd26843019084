"""Trainers, optimization methods, schedules and triggers (counterpart
of bigdl_tpu/optim)."""
