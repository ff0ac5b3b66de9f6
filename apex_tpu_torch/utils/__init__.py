"""Small shared helpers (counterpart of ``apex_tpu.utils``)."""
