"""Logging and stage timing, reused from ``computervisionimagestich2_tpu.
utils.obs`` (that module imports jax only inside ``trace``, which the port
does not use)."""
from computervisionimagestich2_tpu.utils.obs import (  # noqa: F401
    StageTimer,
    log,
    log_sift_overflow,
    set_verbose,
    warn,
)
