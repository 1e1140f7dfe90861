"""Device ms a vocoder-training step of the operations launched in
its backward stage, from the trace (moves train_steps_per_s)."""
from gpubench.readers import voc_bwd_ms as read  # noqa: F401
