"""B5's share of its roofline at the vocoder's GRUs, H 512 (moves
train_steps_per_s)."""
from gpubench.readers import b5_voc_roofline as read  # noqa: F401
