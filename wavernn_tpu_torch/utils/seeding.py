"""Global seeding (reference utils/__init__.py:107-121; the JAX package's
``utils/seeding.py``, copied).

Seeds the ambient generators (numpy, ``random``, torch) for reproducible
runs when hparams define ``random_seed`` (train_tacotron.py:36-37); the
trainers' own generators take the seed explicitly.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_global_seeds(i: int):
    np.random.seed(i)
    random.seed(i)
    torch.manual_seed(i)
