"""A vocoder-training window's share of the float32 peak (moves
train_steps_per_s)."""
from gpubench.readers import voc_train_mfu as read  # noqa: F401
