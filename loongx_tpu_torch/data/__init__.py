"""Datasets and the batch loader (counterpart of ``loongx_tpu/data``)."""
