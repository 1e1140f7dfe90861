"""B5's share of its roofline at the CBHG BiGRUs (moves train_steps_per_s)."""
from gpubench.readers import b5_roofline as read  # noqa: F401
