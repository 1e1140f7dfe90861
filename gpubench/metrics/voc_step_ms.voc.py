"""Device ms a vocoder-training step: the traced window's busy time over
its steps (moves train_steps_per_s)."""
from gpubench.readers import step_device_ms as read  # noqa: F401
