"""Small shared helpers (counterpart of ``apex_tpu.utils``): activations,
NHWC convolution, batch norm, FLOP counts, threefry random numbers and
structured logging."""
