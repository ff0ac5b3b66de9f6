"""Contributed extensions (counterpart of ``apex_tpu.contrib``): the fused
softmax cross entropy so far."""
