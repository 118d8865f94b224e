"""Plain PyTorch version of the chunk_scan kernel: the sequential
recurrence (``models.scan_ops.recurrent_scan``), as the JAX package's
oracle is.  It is the CPU route of the wrapper and the kernel's yardstick
in the tests and ``chip_smoke.py``."""
from repro_torch.models.scan_ops import recurrent_scan


def chunk_scan_ref(r, k, v, log_decay, state0=None, *, include_current=True,
                   bonus=None):
    return recurrent_scan(r, k, v, log_decay, state0,
                          include_current=include_current, bonus=bonus)
