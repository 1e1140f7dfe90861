"""The device's idle share of a training window (moves train_steps_per_s)."""
from gpubench.readers import idle_pct as read  # noqa: F401
