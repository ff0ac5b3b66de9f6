"""Small shared helpers (counterpart of ``apex_tpu.utils``): activations,
NHWC convolution, batch norm and FLOP counts."""
