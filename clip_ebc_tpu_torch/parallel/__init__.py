"""Data parallelism over processes: counterpart of ``clip_ebc_tpu/parallel``."""
